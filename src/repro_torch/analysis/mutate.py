"""Mutation harness: seed known corruption classes into a valid
plan/schedule and assert the verifier catches each with the right code
(a copy of the reference's ``repro/analysis/mutate.py`` over the port's
program, cutter and analyzer: the same 12 classes, names, expected codes
and random draws).

Every mutation is a registered :class:`Mutation` — a pure function that
corrupts one aspect of a :class:`MutableCase` (a deep-enough copy of a
verified program + placement + schedule) in a way that mirrors a real
bug class in the cut/runtime machinery:

=====================  ======  =============================================
mutation               expects  seeded bug class
=====================  ======  =============================================
``use_after_free``     RP001   a refcount decremented one too early (the
                               classic off-by-one in liveness accounting)
``double_free``        RP002   a refcount table entry too small — the
                               runtime frees on first use, then underflows
``double_donation``    RP003   a donation added for a buffer that is still
                               read later (or is a resident/program output)
``drop_transfer``      RP012   a cross-device read whose transfer op was
                               dropped — the jitted segment would consume a
                               remote buffer
``transfer_cycle``     RP011   two segments on different devices cross-wired
                               into a circular wait (async-dispatch hang)
``cross_wire``         RP010   two dependent segments swapped in schedule
                               order (in-order-dispatch deadlock)
``cap_overflow``       RP020   a plan claiming feasibility under caps its
                               own schedule provably exceeds
``placement_hole``     RP032   a node assigned outside ``[0, K)``
``refcount_inflate``   RP034   a refcount table entry too large — buffers
                               outlive their last reader (leak)
``prefetch_rekey``     RP041   a prefetch entry keyed to a segment the
                               schedule never dispatches — the async copy
                               never starts
``prefetch_after_donation`` RP042  a prefetch registered at (or after) the
                               segment that donates its source buffer —
                               the device_put reads deleted memory
``async_cap_overflow`` RP040   capacities the async (prefetch-at-producer)
                               certificate exceeds while the plan claims
                               feasibility
=====================  ======  =============================================

Used by ``tests/test_torch_analysis.py`` (each class caught with the
expected code, and the same codes as the reference's harness on the same
case).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np

from ..core.executor import TracedProgram
from ..core.segments import SegmentSchedule, cut_segments
from . import analyze
from .diagnostics import DiagnosticReport
from .passes import AnalysisContext, abstract_interpret, overlap_interpret


@dataclass
class MutableCase:
    """One analyzable case the mutations corrupt in place."""

    prog: TracedProgram
    assignment: np.ndarray
    k: int
    schedule: SegmentSchedule
    graph: Any = None
    mem_caps: Any = None
    feasible: bool | None = None

    def analyze(self) -> DiagnosticReport:
        return analyze(self.prog, self.assignment, self.k,
                       schedule=self.schedule, graph=self.graph,
                       mem_caps=self.mem_caps, feasible=self.feasible)


def make_case(prog: TracedProgram, assignment: np.ndarray, k: int,
              graph: Any = None) -> MutableCase:
    """Build a fresh case (private schedule/assignment copies) from a
    placed program — the pre-mutation state must verify clean."""
    sched = cut_segments(prog, assignment, k=k)
    return MutableCase(prog=prog, assignment=np.array(assignment),
                       k=k, schedule=_copy_schedule(sched), graph=graph)


def _copy_schedule(s: SegmentSchedule) -> SegmentSchedule:
    return SegmentSchedule(
        segments=list(s.segments), k=s.k,
        node_refcount=dict(s.node_refcount),
        last_consumer_seg=dict(s.last_consumer_seg),
        num_transfer_edges=s.num_transfer_edges,
        prefetch=dict(s.prefetch),
        last_reader_on_dev=dict(s.last_reader_on_dev),
        producer_seg=dict(s.producer_seg))


MutationFn = Callable[[MutableCase, np.random.Generator], bool]


@dataclass(frozen=True)
class Mutation:
    name: str
    expect_code: str        # the diagnostic code the verifier must emit
    description: str
    apply: MutationFn       # returns False when the case is too small


MUTATIONS: dict[str, Mutation] = {}


def _mutation(name: str, expect_code: str,
              description: str) -> Callable[[MutationFn], MutationFn]:
    def register(fn: MutationFn) -> MutationFn:
        MUTATIONS[name] = Mutation(name=name, expect_code=expect_code,
                                   description=description, apply=fn)
        return fn
    return register


def apply_mutation(name: str, case: MutableCase,
                   rng: np.random.Generator) -> bool:
    """Apply a registered mutation; False when it does not fit the case
    (e.g. no cross-device transfer exists to drop)."""
    return MUTATIONS[name].apply(case, rng)


def _roots(prog: TracedProgram) -> set[int]:
    return set(prog.input_nodes) | {nid for nid, _ in prog.const_nodes}


def _pick(rng: np.random.Generator, items: list) -> Any:
    return items[int(rng.integers(len(items)))]


# ---------------------------------------------------------------------------
@_mutation("use_after_free", "RP001",
           "decrement a refcount table entry: frees before the last reader")
def _use_after_free(case: MutableCase, rng: np.random.Generator) -> bool:
    rc = case.schedule.node_refcount
    victims = [p for p, n in rc.items()
               if n >= 2 and p in case.prog.program]
    if not victims:
        return False
    rc[_pick(rng, victims)] -= 1
    return True


@_mutation("double_free", "RP002",
           "zero a refcount table entry: the first consumer underflows it")
def _double_free(case: MutableCase, rng: np.random.Generator) -> bool:
    consumed = {s[0] for seg in case.schedule.segments for s in seg.inputs}
    victims = [p for p, n in case.schedule.node_refcount.items()
               if n >= 1 and p in consumed]
    if not victims:
        return False
    case.schedule.node_refcount[_pick(rng, victims)] = 0
    return True


@_mutation("double_donation", "RP003",
           "donate a buffer that is a resident or still has later readers")
def _double_donation(case: MutableCase, rng: np.random.Generator) -> bool:
    segs = case.schedule.segments
    roots = _roots(case.prog)
    out_slots = {s for s in case.prog.out_slots if s is not None}
    readers: dict[tuple[int, int], list[int]] = {}
    for i, seg in enumerate(segs):
        for slot in seg.inputs:
            readers.setdefault(slot, []).append(i)
    sites = []
    for i, seg in enumerate(segs):
        dead = set(seg.dead_inputs)
        xfer = set(seg.transfer_inputs)
        for pos, slot in enumerate(seg.inputs):
            if pos in dead:
                continue
            src = slot[0]
            crosses = int(case.assignment[src]) != seg.device
            if pos in xfer and crosses:
                continue    # donating the copy is only a lint, not an error
            illegal = (src in roots or slot in out_slots
                       or any(j > i for j in readers.get(slot, ())))
            if illegal:
                sites.append((i, pos))
    if not sites:
        return False
    i, pos = _pick(rng, sites)
    segs[i] = replace(segs[i], dead_inputs=segs[i].dead_inputs + (pos,))
    return True


@_mutation("drop_transfer", "RP012",
           "remove a transfer marking from a cross-device read")
def _drop_transfer(case: MutableCase, rng: np.random.Generator) -> bool:
    segs = case.schedule.segments
    sites = [(i, pos) for i, seg in enumerate(segs)
             for pos in seg.transfer_inputs
             if int(case.assignment[seg.inputs[pos][0]]) != seg.device]
    if not sites:
        return False
    i, pos = _pick(rng, sites)
    seg = segs[i]
    segs[i] = replace(
        seg,
        transfer_inputs=tuple(p for p in seg.transfer_inputs if p != pos),
        dead_inputs=tuple(p for p in seg.dead_inputs if p != pos))
    return True


@_mutation("transfer_cycle", "RP011",
           "cross-wire two segments on different devices into a cycle")
def _transfer_cycle(case: MutableCase, rng: np.random.Generator) -> bool:
    segs = case.schedule.segments
    produced_at = {}
    for i, seg in enumerate(segs):
        for slot in seg.outputs:
            produced_at.setdefault(slot, i)
    pairs = []
    for j, seg in enumerate(segs):
        if not seg.outputs:
            continue
        for slot in seg.inputs:
            i = produced_at.get(slot)
            if i is not None and i < j and segs[i].device != seg.device:
                pairs.append((i, j))
                break
    if not pairs:
        return False
    i, j = _pick(rng, pairs)
    a = segs[i]
    back_slot = segs[j].outputs[0]
    segs[i] = replace(
        a, inputs=a.inputs + (back_slot,),
        transfer_inputs=a.transfer_inputs + (len(a.inputs),))
    return True


@_mutation("cross_wire", "RP010",
           "swap two dependent segments in schedule order")
def _cross_wire(case: MutableCase, rng: np.random.Generator) -> bool:
    segs = case.schedule.segments
    produced_at = {}
    for i, seg in enumerate(segs):
        for slot in seg.outputs:
            produced_at.setdefault(slot, i)
    pairs = []
    for j, seg in enumerate(segs):
        for slot in seg.inputs:
            i = produced_at.get(slot)
            if i is not None and i < j:
                pairs.append((i, j))
                break
    if not pairs:
        return False
    i, j = _pick(rng, pairs)
    segs[i], segs[j] = segs[j], segs[i]
    return True


@_mutation("cap_overflow", "RP020",
           "claim feasibility under caps the schedule provably exceeds")
def _cap_overflow(case: MutableCase, rng: np.random.Generator) -> bool:
    if case.graph is None:
        return False
    ctx = AnalysisContext(prog=case.prog, assignment=case.assignment,
                          k=case.k, schedule=case.schedule, graph=case.graph)
    peaks = abstract_interpret(ctx).cert_peaks
    if peaks is None or float(np.max(peaks)) <= 0:
        return False
    case.mem_caps = np.full(case.k, float(np.max(peaks)) * 0.5)
    case.feasible = True
    return True


@_mutation("placement_hole", "RP032",
           "assign a node outside [0, K)")
def _placement_hole(case: MutableCase, rng: np.random.Generator) -> bool:
    nodes = sorted(case.prog.program)
    if not nodes:
        return False
    nid = _pick(rng, nodes)
    case.assignment[nid] = case.k if rng.integers(2) else -1
    return True


@_mutation("refcount_inflate", "RP034",
           "inflate a refcount table entry: buffers outlive their reader")
def _refcount_inflate(case: MutableCase, rng: np.random.Generator) -> bool:
    rc = case.schedule.node_refcount
    if not rc:
        return False
    rc[_pick(rng, sorted(rc))] += 2
    return True


@_mutation("prefetch_rekey", "RP041",
           "key a prefetch entry to a segment that never dispatches")
def _prefetch_rekey(case: MutableCase, rng: np.random.Generator) -> bool:
    pf = case.schedule.prefetch
    keys = sorted(k for k in pf if pf[k])
    if not keys:
        return False
    psid = _pick(rng, keys)
    entries = list(pf[psid])
    i = int(rng.integers(len(entries)))
    moved = entries.pop(i)
    if entries:
        pf[psid] = tuple(entries)
    else:
        del pf[psid]
    ghost = max(seg.sid for seg in case.schedule.segments) + 7
    pf[ghost] = pf.get(ghost, ()) + (moved,)
    return True


@_mutation("prefetch_after_donation", "RP042",
           "register a prefetch at the segment donating its source buffer")
def _prefetch_after_donation(case: MutableCase,
                             rng: np.random.Generator) -> bool:
    if case.k < 2:
        return False
    sites: list[tuple[int, tuple[int, int], int]] = []
    for seg in case.schedule.segments:
        xfer = set(seg.transfer_inputs)
        for p in seg.dead_inputs:
            if 0 <= p < len(seg.inputs) and p not in xfer:
                sites.append((seg.sid, seg.inputs[p], seg.device))
    if not sites:
        return False
    sid, slot, dev = _pick(rng, sites)
    dst = (dev + 1) % case.k
    pf = case.schedule.prefetch
    pf[sid] = pf.get(sid, ()) + ((slot, dst),)
    return True


@_mutation("async_cap_overflow", "RP040",
           "claim feasibility under caps the async certificate exceeds")
def _async_cap_overflow(case: MutableCase, rng: np.random.Generator) -> bool:
    if case.graph is None:
        return False
    ctx = AnalysisContext(prog=case.prog, assignment=case.assignment,
                          k=case.k, schedule=case.schedule, graph=case.graph)
    apeaks = overlap_interpret(ctx).cert_peaks
    speaks = abstract_interpret(ctx).cert_peaks
    if apeaks is None or speaks is None or float(np.max(apeaks)) <= 0:
        return False
    # prefer a cap between the lazy and async certificates — that
    # isolates the overlap-specific risk (prefetch holds copies live
    # earlier); fall back to an unconditional breach when they coincide
    gap = apeaks > speaks
    if bool(np.any(gap)):
        caps = np.where(gap, (apeaks + speaks) / 2.0, apeaks * 2.0 + 1.0)
    else:
        caps = apeaks * 0.5
    case.mem_caps = caps
    case.feasible = True
    return True
