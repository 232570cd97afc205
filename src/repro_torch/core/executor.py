"""Graph executor: the recorded program of a trace and the op-by-op
interpreter that runs it under a placement (the port's side of the
reference's ``repro/core/executor.py``).

The tracer (:mod:`.tracing`) records, for every op node of the cost
graph, the aten op, its keyword arguments and its positional inputs, so
that a placement can replay the program node by node. Two engines
realize a placement:

* this module's :func:`execute`: the op-by-op *interpreter*, one aten
  call per node on its PE's ``torch.device``, every intermediate kept
  alive. Slow, but the executable specification the compiled path is
  held to.
* ``core.runtime.CompiledRuntime``: the *segment runtime*, which cuts
  the placed program into maximal same-PE segments (``core.segments``),
  captures each one as a CUDA graph on its PE's stream, and frees
  buffers by liveness.

Both consume the same :class:`TracedProgram`, which carries a liveness
table (``consumers`` / ``output_nodes``) computed at trace time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..tree import tree_flatten, tree_unflatten
from .errors import RP104_DEVICE_MISMATCH, PlanValidationError


@dataclass
class TracedProgram:
    # node -> (OpOverload, kwargs, inputs); inputs are the leaves of the
    # op's positional arguments, each ("slot", src_node, out_idx) or
    # ("lit", value), rebuilt into the arguments by ``arg_specs[node]``
    program: dict[int, tuple]
    n_outputs: dict[int, int]
    input_nodes: list[int]               # node ids of the input leaves
    const_nodes: list[tuple[int, Any]]   # (node id, const value)
    out_slots: list[tuple[int, int] | None]
    out_tree: Any                        # rebuilds the outputs from leaves
    in_tree_example: Any
    # liveness table (computed at trace time; see ``compute_liveness``):
    # consumers[p] — sorted program-node ids that read any output of p;
    # output_nodes — producers referenced by out_slots (never freeable).
    consumers: dict[int, tuple[int, ...]] | None = field(default=None)
    output_nodes: frozenset[int] | None = field(default=None)
    # node -> torch.utils._pytree.TreeSpec of its positional arguments
    arg_specs: dict[int, Any] = field(default_factory=dict)

    def liveness(self) -> tuple[dict[int, tuple[int, ...]], frozenset[int]]:
        """The (consumers, output_nodes) table, computing it on demand for
        programs built before tracing recorded liveness."""
        if self.consumers is None or self.output_nodes is None:
            self.consumers, self.output_nodes = compute_liveness(self)
        return self.consumers, self.output_nodes

    def last_consumer(self, nid: int) -> int:
        """Highest-id program node reading ``nid``'s output, or -1. Node
        ids are a topological order, so this is the last consumer under
        any schedule that respects the id order."""
        consumers, _ = self.liveness()
        cs = consumers.get(nid)
        return int(cs[-1]) if cs else -1


def compute_liveness(prog: TracedProgram
                     ) -> tuple[dict[int, tuple[int, ...]], frozenset[int]]:
    """Build the consumers / output-nodes liveness table from the
    recorded program (the executable definition the trace-time table is
    pinned to)."""
    consumers: dict[int, set[int]] = {}
    for nid, (_, _, inputs) in prog.program.items():
        for inp in inputs:
            if inp[0] == "slot":
                consumers.setdefault(inp[1], set()).add(nid)
    table = {p: tuple(sorted(cs)) for p, cs in consumers.items()}
    outputs = frozenset(s[0] for s in prog.out_slots if s is not None)
    return table, outputs


def validate_device_count(assignment: np.ndarray | None,
                          devices: list | None) -> None:
    """A placement must name a real device for every PE it uses.

    Raises :class:`PlanValidationError` when the plan has more PEs than
    devices: silently aliasing PEs onto the same device voids the plan's
    memory guarantees. Callers that *want* device reuse must pass an
    explicitly expanded device list (e.g. via
    ``PartitionPlan.execute(device_map=...)``).
    """
    if assignment is None or devices is None:
        return
    if len(assignment) == 0:
        return
    max_pe = int(np.max(assignment))
    if max_pe >= len(devices):
        raise PlanValidationError(
            f"placement uses {max_pe + 1} PEs but only {len(devices)} "
            f"devices were given — refusing to alias PEs onto shared "
            f"devices implicitly (that voids the plan's per-device "
            f"memory guarantees). Pass an explicit device_map (e.g. "
            f"device_map=[0]*{max_pe + 1} to fold onto one device) or "
            f"run with more devices.", code=RP104_DEVICE_MISMATCH)


def node_kwargs(kwargs: dict, device) -> dict:
    """A node's keyword arguments for a run on ``device``: an op that
    creates a tensor (``arange``, ``ones``, ``scalar_tensor``) names the
    device it traced on, and runs on its PE's device instead."""
    if device is None or "device" not in kwargs:
        return kwargs
    return dict(kwargs, device=device)


def run_node(prog: TracedProgram, nid: int, vals: list, kwargs: dict,
             op=None):
    """One node's aten call on its input values (the leaves of its
    positional arguments, literals included), as the trace recorded it;
    ``op`` runs another op on the same arguments (the segment runtime's
    in-place form of a functional write)."""
    op = prog.program[nid][0] if op is None else op
    return op(*pytree.tree_unflatten(vals, prog.arg_specs[nid]), **kwargs)


def execute(prog: TracedProgram, assignment: np.ndarray | None,
            devices: list | None, *args, **kwargs):
    """Execute the traced program under a placement, op by op.

    ``assignment[node] -> pe``; ``devices[pe]`` the ``torch.device`` the
    PE runs on. With ``assignment=None`` everything runs where its
    inputs are (reference mode). A read of a value that lives on another
    device is a ``.to(device)`` copy; with PEs folded onto one device it
    is the value itself. Every intermediate stays alive until the call
    returns: this is the all-live baseline the segment runtime's
    refcount freeing is measured against."""
    flat_args, _ = tree_flatten((args, kwargs))
    if len(flat_args) != len(prog.input_nodes):
        raise ValueError(
            f"expected {len(prog.input_nodes)} leaves, got {len(flat_args)}")
    validate_device_count(assignment, devices)
    if devices is not None:
        devices = [torch.device(d) for d in devices]

    def dev_of(nid: int):
        if assignment is None or devices is None:
            return None
        return devices[int(assignment[nid])]

    def place(v, d):
        if d is not None and isinstance(v, torch.Tensor):
            return v.to(d)
        return v

    vals: dict[int, Any] = {}
    for nid, cval in prog.const_nodes:
        vals[nid] = place(cval, dev_of(nid))
    for nid, a in zip(prog.input_nodes, flat_args):
        vals[nid] = place(a, dev_of(nid))

    def read(src: int, idx: int):
        v = vals[src]
        return v[idx] if isinstance(v, (tuple, list)) else v

    for nid in sorted(prog.program):
        _, node_kw, inputs = prog.program[nid]
        d = dev_of(nid)
        invals = [inp[1] if inp[0] == "lit" else place(read(inp[1], inp[2]), d)
                  for inp in inputs]
        vals[nid] = run_node(prog, nid, invals, node_kwargs(node_kw, d))

    outs = [None if slot is None else read(*slot) for slot in prog.out_slots]
    return tree_unflatten(prog.out_tree, outs)


__all__ = ["TracedProgram", "compute_liveness", "execute", "node_kwargs",
           "run_node", "validate_device_count"]
