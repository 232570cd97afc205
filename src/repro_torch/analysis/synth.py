"""Random synthetic :class:`TracedProgram` generator for property tests
(a copy of the reference's ``repro/analysis/synth.py``: the same
``np.random.Generator`` draws in the same order, so a seed gives both
packages the same program and assignment).

The verifier never binds primitives — every pass works off the program's
*structure* (slots, liveness, placement). So synthetic programs use
plain string prims: they are analyzable and cuttable but **not
executable**. That keeps the generator dependency-free and fast enough
for hundreds of Hypothesis examples.

The core property the suite asserts over this generator:

* ``cut_segments`` of a random placed program verifies **clean** (zero
  error diagnostics) — the analyzer and the cutter agree on the
  liveness/donation/transfer contract;
* any registered mutation of that schedule yields ≥ 1 error diagnostic.
"""
from __future__ import annotations

import numpy as np

from ..core.executor import TracedProgram


def random_program(rng: np.random.Generator, *, n_ops: int = 12,
                   n_inputs: int = 2, n_consts: int = 1,
                   p_multi: float = 0.2, max_fanin: int = 3,
                   n_prog_outputs: int = 2) -> TracedProgram:
    """A random connected DAG in ``TracedProgram`` form (analysis-only).

    Node ids are dense and ascending (a topological order, as the tracer
    guarantees). Every op consumes at least one earlier slot; program
    outputs are drawn with a bias toward late nodes so most values have
    real consumers.
    """
    n_ops = max(int(n_ops), 1)
    n_inputs = max(int(n_inputs), 1)
    n_consts = max(int(n_consts), 0)

    input_nodes = list(range(n_inputs))
    const_nodes = [(n_inputs + i, np.float32(i + 1.0))
                   for i in range(n_consts)]
    n_roots = n_inputs + n_consts

    program: dict[int, tuple] = {}
    n_outputs: dict[int, int] = {}
    slots: list[tuple[int, int]] = [(nid, 0) for nid in range(n_roots)]

    for j in range(n_ops):
        nid = n_roots + j
        fanin = int(rng.integers(1, max_fanin + 1))
        inputs = []
        # bias toward recent slots so chains form instead of a star
        for _ in range(fanin):
            if len(slots) > 1 and rng.random() < 0.6:
                lo = max(0, len(slots) - 6)
                src = slots[int(rng.integers(lo, len(slots)))]
            else:
                src = slots[int(rng.integers(len(slots)))]
            inputs.append(("slot", src[0], src[1]))
        if rng.random() < 0.15:
            inputs.append(("lit", float(rng.random())))
        n_out = 2 if rng.random() < p_multi else 1
        program[nid] = (f"synth_op{j}", {}, tuple(inputs))
        n_outputs[nid] = n_out
        for idx in range(n_out):
            slots.append((nid, idx))

    for nid in input_nodes:
        n_outputs[nid] = 1
    for nid, _ in const_nodes:
        n_outputs[nid] = 1

    # program outputs: the last op always, plus a few random late slots
    op_slots = [s for s in slots if s[0] >= n_roots]
    out_slots: list[tuple[int, int]] = [op_slots[-1]]
    n_extra = min(max(n_prog_outputs - 1, 0), len(op_slots) - 1)
    if n_extra > 0:
        lo = max(0, len(op_slots) - max(4, n_extra + 1))
        picks = rng.choice(np.arange(lo, len(op_slots) - 1),
                           size=n_extra, replace=False)
        for i in sorted(int(p) for p in picks):
            if op_slots[i] not in out_slots:
                out_slots.append(op_slots[i])

    return TracedProgram(program=program, n_outputs=n_outputs,
                         input_nodes=input_nodes, const_nodes=const_nodes,
                         out_slots=out_slots, out_tree=None,
                         in_tree_example=None)


def random_assignment(rng: np.random.Generator, prog: TracedProgram,
                      k: int) -> np.ndarray:
    """A random placement over ``k`` devices, covering roots and ops."""
    n = 1 + max(max(prog.program, default=0),
                max(prog.input_nodes, default=0),
                max((nid for nid, _ in prog.const_nodes), default=0))
    return rng.integers(0, k, size=n).astype(np.int64)
