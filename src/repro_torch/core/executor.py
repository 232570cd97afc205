"""The recorded program of a trace (the port's side of the reference's
``repro/core/executor.py``: its :class:`TracedProgram` and
:func:`compute_liveness`).

The tracer (:mod:`.tracing`) records, for every op node of the cost
graph, the aten op, its keyword arguments and its positional inputs, so
that a placement can replay the program node by node. The op-by-op
interpreter and the compiled segment runtime that consume it are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


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


__all__ = ["TracedProgram", "compute_liveness"]
