"""The static-analysis passes: prove schedule safety without executing.

Each pass is a pure function over an :class:`AnalysisContext` (the
traced program, the placement, the segment schedule, and the plan's
claims) appending :class:`~repro_torch.analysis.diagnostics.Diagnostic`
findings to a report. A copy of the reference's
``repro/analysis/passes.py``: nothing here touches a device, and the
passes certify, ahead of time, the reference runtime's schedule (its
donations included), whose refcounts, transfers and prefetches
``core.runtime.CompiledRuntime`` follows:

* ``placement`` — every node placed exactly once on a device in
  ``[0, K)`` (RP032).
* ``structure`` — the schedule covers every program node exactly once,
  segments sit on the device their nodes are assigned to, intra-segment
  node order is topological, exports are computed by the exporting
  segment, and the schedule's refcount table matches the recomputed
  segment-level liveness (RP010/RP013/RP014/RP015/RP032/RP034).
* ``deadlock`` — no segment consumes a value produced by a later
  segment (RP010: a hang under in-order dispatch) and the combined
  dataflow + per-device-chain graph is acyclic (RP011: a hang under
  async per-device dispatch).
* ``liveness`` — an abstract interpreter replays the runtime's
  refcount/donation/transfer schedule and proves no use-after-free
  (RP001), no refcount underflow (RP002), no double- or unsafe donation
  (RP003), no missing transfer op (RP012), and no leaked buffer
  (RP004); redundant transfers and self-transfers are linted (RP030).
* ``memory`` — an emulator-independent per-device peak-memory
  certificate: re-runs the same abstract interpretation charging the
  cost graph's per-node output bytes, checks the certified peaks
  against the plan's capacity claim (RP020) and cross-checks Step-2's
  prediction (RP021, tolerance ``4x + 8 MiB`` — the conformance
  matrix's documented measured-vs-predicted policy).
* ``overlap`` — certifies the *async* dispatch schedule the default
  runtime mode executes: the prefetch table is consistent (every entry
  exported by its keyed producer — or a root for key ``-1`` — targets
  a real device, and is registered no later than its first consumer;
  RP041), no prefetched ``device_put`` can read a buffer a segment
  already donated (RP042), and a second abstract interpretation with
  *prefetch-at-producer* buffer lifetimes re-certifies the per-device
  peaks against the capacity claim plus the in-flight transfer-window
  bound (RP040 — async dispatch holds transferred copies live earlier
  than the lazy schedule the ``memory`` pass certifies).
* ``lint`` — dead nodes / unused outputs (RP031).

Pass functions are registered in :data:`PASSES`; ``repro_torch.analysis
.analyze`` orchestrates them (placement holes disable the schedule
passes — a broken placement cannot be cut meaningfully).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..core import errors as E
from ..core.executor import TracedProgram
from ..core.runtime import _resolve_window
from ..core.segments import SegmentSchedule, Slot
from .diagnostics import ERROR, INFO, WARN, Diagnostic, DiagnosticReport

#: RP021 tolerance: certificate vs Step-2 prediction (matches the
#: conformance matrix's measured-vs-predicted policy, ARCHITECTURE.md).
PEAK_DRIFT_FACTOR = 4.0
PEAK_DRIFT_SLACK = 8 * 2 ** 20


@dataclass
class AnalysisContext:
    """Everything a pass may consult. ``schedule`` may be a corrupted
    schedule under test — passes must diagnose, never crash."""

    prog: TracedProgram | None
    assignment: np.ndarray | None
    k: int
    schedule: SegmentSchedule | None = None
    graph: Any = None                       # CostGraph (mem/names), optional
    mem_caps: np.ndarray | None = None      # per-device capacity bytes
    feasible: bool | None = None            # the plan's feasibility claim
    predicted_peaks: np.ndarray | None = None   # Step-2 per-device peaks
    # in-flight transfer-window bound the overlap pass certifies
    # against (None: REPRO_TRANSFER_WINDOW_MB env or the 64 MiB default,
    # same resolution the runtime uses)
    transfer_window_bytes: float | None = None
    # caches shared between passes
    _interp: "InterpResult | None" = field(default=None, repr=False)
    _overlap: "OverlapInterpResult | None" = field(default=None, repr=False)

    def dev(self, nid: int) -> int:
        if self.assignment is None:
            return 0
        return int(self.assignment[nid])


PassFn = Callable[[AnalysisContext, DiagnosticReport], None]

PASSES: dict[str, PassFn] = {}


def analysis_pass(name: str) -> Callable[[PassFn], PassFn]:
    def register(fn: PassFn) -> PassFn:
        PASSES[name] = fn
        return fn
    return register


def _diag(rep: DiagnosticReport, code: str, severity: str, message: str,
          pass_name: str, *, node: int | None = None,
          segment: int | None = None, device: int | None = None) -> None:
    rep.add(Diagnostic(code=code, severity=severity, message=message,
                       pass_name=pass_name, node=node, segment=segment,
                       device=device))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
@analysis_pass("placement")
def placement_pass(ctx: AnalysisContext, rep: DiagnosticReport) -> None:
    """RP032: every node assigned exactly one device in ``[0, K)``."""
    a = ctx.assignment
    if a is None:
        return
    a = np.asarray(a)
    if a.ndim != 1:
        _diag(rep, E.RP032_PLACEMENT_HOLE, ERROR,
              f"assignment must be 1-D (node -> pe), got shape {a.shape}",
              "placement")
        return
    if a.size == 0:
        return
    if not np.issubdtype(a.dtype, np.integer):
        _diag(rep, E.RP032_PLACEMENT_HOLE, ERROR,
              f"assignment dtype {a.dtype} is not integral — fractional "
              f"or missing placements cannot be realized", "placement")
        return
    bad = np.flatnonzero((a < 0) | (a >= ctx.k))
    for nid in bad[:20]:
        _diag(rep, E.RP032_PLACEMENT_HOLE, ERROR,
              f"node {int(nid)} assigned to pe {int(a[nid])}, outside "
              f"[0, {ctx.k})", "placement", node=int(nid),
              device=int(a[nid]))
    if bad.size > 20:
        _diag(rep, E.RP032_PLACEMENT_HOLE, ERROR,
              f"... and {bad.size - 20} more nodes placed outside "
              f"[0, {ctx.k})", "placement")
    if ctx.graph is not None and getattr(ctx.graph, "n", a.size) != a.size:
        _diag(rep, E.RP032_PLACEMENT_HOLE, ERROR,
              f"assignment covers {a.size} nodes but the graph has "
              f"{ctx.graph.n}", "placement")


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------
def _recount_refcounts(ctx: AnalysisContext) -> dict[int, int]:
    """Recompute the segment-level refcount table from the schedule
    itself (the executable definition the stored table must match)."""
    assert ctx.prog is not None and ctx.schedule is not None
    _, output_nodes = ctx.prog.liveness()
    cons_segs: dict[int, set[int]] = {}
    for seg in ctx.schedule.segments:
        for slot in seg.inputs:
            cons_segs.setdefault(slot[0], set()).add(seg.sid)
    rc = {p: len(s) for p, s in cons_segs.items()}
    for p in output_nodes:
        rc[p] = rc.get(p, 0) + 1
    return rc


@analysis_pass("structure")
def structure_pass(ctx: AnalysisContext, rep: DiagnosticReport) -> None:
    """Coverage, device consistency, intra-segment order, export
    ownership, refcount-table fidelity."""
    prog, sched = ctx.prog, ctx.schedule
    assert prog is not None and sched is not None
    seen: dict[int, int] = {}
    for seg in sched.segments:
        if not 0 <= seg.device < ctx.k:
            _diag(rep, E.RP032_PLACEMENT_HOLE, ERROR,
                  f"segment {seg.sid} sits on pe {seg.device}, outside "
                  f"[0, {ctx.k})", "structure", segment=seg.sid,
                  device=seg.device)
        run_pos = {nid: j for j, nid in enumerate(seg.nodes)}
        for nid in seg.nodes:
            if nid in seen:
                _diag(rep, E.RP015_NODE_SCHEDULED_TWICE, ERROR,
                      f"node {nid} scheduled in segments {seen[nid]} and "
                      f"{seg.sid}", "structure", node=nid, segment=seg.sid)
                continue
            seen[nid] = seg.sid
            if nid not in prog.program:
                _diag(rep, E.RP013_UNDEFINED_VALUE, ERROR,
                      f"segment {seg.sid} schedules node {nid}, which the "
                      f"program does not define", "structure", node=nid,
                      segment=seg.sid)
                continue
            if ctx.dev(nid) != seg.device:
                _diag(rep, E.RP032_PLACEMENT_HOLE, ERROR,
                      f"node {nid} is assigned to pe {ctx.dev(nid)} but "
                      f"scheduled in segment {seg.sid} on pe {seg.device}",
                      "structure", node=nid, segment=seg.sid,
                      device=seg.device)
            for inp in prog.program[nid][2]:
                if inp[0] == "slot" and inp[1] in run_pos \
                        and run_pos[inp[1]] >= run_pos[nid]:
                    _diag(rep, E.RP010_ORDER_VIOLATION, ERROR,
                          f"node {nid} reads node {inp[1]} scheduled at or "
                          f"after it inside segment {seg.sid}", "structure",
                          node=nid, segment=seg.sid)
        node_set = set(seg.nodes)
        for slot in seg.outputs:
            if slot[0] not in node_set:
                _diag(rep, E.RP013_UNDEFINED_VALUE, ERROR,
                      f"segment {seg.sid} exports slot {slot} but does not "
                      f"compute node {slot[0]}", "structure", node=slot[0],
                      segment=seg.sid)
    for nid in prog.program:
        if nid not in seen:
            _diag(rep, E.RP014_NODE_NOT_SCHEDULED, ERROR,
                  f"program node {nid} ({prog.program[nid][0]!s}) appears "
                  f"in no segment", "structure", node=nid)
    # refcount table fidelity (the liveness machinery's ground truth)
    expected = _recount_refcounts(ctx)
    stored = sched.node_refcount
    drifted = {p for p in set(expected) | set(stored)
               if expected.get(p) != stored.get(p)}
    for p in sorted(drifted)[:20]:
        _diag(rep, E.RP034_REFCOUNT_TABLE_DRIFT, ERROR,
              f"node {p}: schedule refcount {stored.get(p)} != recomputed "
              f"{expected.get(p)} — the runtime would free too early or "
              f"leak", "structure", node=p)
    if len(drifted) > 20:
        _diag(rep, E.RP034_REFCOUNT_TABLE_DRIFT, ERROR,
              f"... and {len(drifted) - 20} more refcount drifts",
              "structure")


# ---------------------------------------------------------------------------
# deadlock / acyclicity
# ---------------------------------------------------------------------------
@analysis_pass("deadlock")
def deadlock_pass(ctx: AnalysisContext, rep: DiagnosticReport) -> None:
    """RP010: forward reads (hang under in-order dispatch). RP011: a
    cycle in the dataflow + per-device-chain graph (hang under async
    per-device dispatch — each device drains its own segments in
    schedule order, so the chain edges are real dependencies)."""
    prog, sched = ctx.prog, ctx.schedule
    assert prog is not None and sched is not None
    segs = sched.segments
    n = len(segs)
    produced_at: dict[Slot, int] = {}
    for i, seg in enumerate(segs):
        for slot in seg.outputs:
            produced_at.setdefault(slot, i)
    roots = set(prog.input_nodes) | {nid for nid, _ in prog.const_nodes}

    adj: list[set[int]] = [set() for _ in range(n)]
    for i, seg in enumerate(segs):
        for slot in seg.inputs:
            j = produced_at.get(slot)
            if j is None or j == i:
                continue        # root/undefined: liveness pass reports
            adj[j].add(i)
            if j > i:
                _diag(rep, E.RP010_ORDER_VIOLATION, ERROR,
                      f"segment {seg.sid} (position {i}) consumes slot "
                      f"{slot} produced by segment {segs[j].sid} at later "
                      f"position {j} — in-order dispatch deadlocks",
                      "deadlock", node=slot[0], segment=seg.sid)
    # per-device chains: a device executes its segments in schedule order
    last_on_dev: dict[int, int] = {}
    for i, seg in enumerate(segs):
        j = last_on_dev.get(seg.device)
        if j is not None:
            adj[j].add(i)
        last_on_dev[seg.device] = i
    # Kahn's algorithm: any unconsumed residue is a genuine circular wait
    indeg = [0] * n
    for u in range(n):
        for v in adj[u]:
            indeg[v] += 1
    stack = [u for u in range(n) if indeg[u] == 0]
    reached = 0
    while stack:
        u = stack.pop()
        reached += 1
        for v in adj[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(v)
    if reached != n:
        cyc = sorted(segs[u].sid for u in range(n) if indeg[u] > 0)
        _diag(rep, E.RP011_DEPENDENCY_CYCLE, ERROR,
              f"segment/transfer dependency graph has a cycle through "
              f"segments {cyc[:10]}{'...' if len(cyc) > 10 else ''} — "
              f"async dispatch would hang", "deadlock",
              segment=cyc[0] if cyc else None)
    del roots  # documented: root reads never create segment edges


# ---------------------------------------------------------------------------
# the abstract interpreter (shared by liveness + memory passes)
# ---------------------------------------------------------------------------
@dataclass
class InterpResult:
    diagnostics: list[Diagnostic]
    cert_peaks: np.ndarray | None       # per-device certified peak bytes
    cert_resident: np.ndarray | None    # per-device resident (input/const)
    freed_values: int = 0
    transfers: int = 0


def _slot_bytes(ctx: AnalysisContext, slot: Slot) -> float:
    """Static byte size of one output slot: the cost graph's per-node
    output bytes split evenly across the node's outputs (the graph
    records node totals; slots of multi-output nodes share them)."""
    g = ctx.graph
    if g is None or ctx.prog is None:
        return 0.0
    mem = g.mem
    nid = slot[0]
    if nid >= len(mem):
        return 0.0
    n_out = max(ctx.prog.n_outputs.get(nid, 1), 1)
    return float(mem[nid]) / n_out


def abstract_interpret(ctx: AnalysisContext) -> InterpResult:
    """Replay the compiled runtime's refcount/donation/transfer schedule
    abstractly — the exact control flow of ``CompiledRuntime.__call__``
    with live values replaced by liveness states and byte counters.

    Emits RP001/RP002/RP003/RP004/RP012/RP030 diagnostics and, when a
    cost graph with byte annotations is attached, certifies per-device
    peak live bytes. The result is cached on the context.
    """
    if ctx._interp is not None:
        return ctx._interp
    prog, sched = ctx.prog, ctx.schedule
    assert prog is not None and sched is not None
    diags: list[Diagnostic] = []

    def emit(code: str, severity: str, message: str, *,
             node: int | None = None, segment: int | None = None,
             device: int | None = None) -> None:
        diags.append(Diagnostic(code=code, severity=severity,
                                message=message, pass_name="liveness",
                                node=node, segment=segment, device=device))

    consumers_tbl, output_nodes = prog.liveness()
    del consumers_tbl
    out_slot_set = {s for s in prog.out_slots if s is not None}
    roots = set(prog.input_nodes) | {nid for nid, _ in prog.const_nodes}
    prog_nodes = set(prog.program)
    segs = sched.segments

    track_bytes = ctx.graph is not None and len(getattr(
        ctx.graph, "mem", [])) > 0
    k = max(ctx.k, 1)
    live_b = np.zeros(k)
    peak_b = np.zeros(k)

    def alloc(pe: int, nb: float) -> None:
        if 0 <= pe < k:
            live_b[pe] += nb
            peak_b[pe] = max(peak_b[pe], live_b[pe])

    def free_b(pe: int, nb: float) -> None:
        if 0 <= pe < k:
            live_b[pe] -= nb

    # residents: graph inputs and constants, committed for the whole call
    if track_bytes:
        for nid in list(prog.input_nodes) + [n for n, _ in prog.const_nodes]:
            alloc(ctx.dev(nid), _slot_bytes(ctx, (nid, 0))
                  * max(prog.n_outputs.get(nid, 1), 1))
    resident = live_b.copy()

    # static maps: who produces / reads every slot (schedule positions)
    produced_at: dict[Slot, int] = {}
    slots_by_producer: dict[int, list[Slot]] = {}
    for i, seg in enumerate(segs):
        for slot in seg.outputs:
            produced_at.setdefault(slot, i)
            slots_by_producer.setdefault(slot[0], []).append(slot)
    readers: dict[Slot, list[tuple[int, int]]] = {}
    for i, seg in enumerate(segs):
        for slot in seg.inputs:
            readers.setdefault(slot, []).append((i, seg.device))

    refcount = dict(sched.node_refcount)
    underflowed: set[int] = set()
    produced: set[Slot] = set()
    freed: set[Slot] = set()
    donated: set[Slot] = set()
    cache: set[tuple[Slot, int]] = set()
    ever_transferred: set[tuple[Slot, int]] = set()
    cache_by_src: dict[int, list[tuple[Slot, int]]] = {}
    n_freed = 0
    n_transfers = 0

    for i, seg in enumerate(segs):
        transfer_pos = set(seg.transfer_inputs)
        donate_set = set(seg.dead_inputs)
        dying_copy_bytes = 0.0
        for p in seg.dead_inputs:
            if p < 0 or p >= len(seg.inputs):
                emit(E.RP003_BAD_DONATION, ERROR,
                     f"segment {seg.sid} donates input position {p}, out "
                     f"of range for its {len(seg.inputs)} inputs",
                     segment=seg.sid)
        # --- reads + transfer execution -----------------------------------
        for pos, slot in enumerate(seg.inputs):
            src = slot[0]
            is_root = src in roots
            if not is_root and src not in prog_nodes:
                emit(E.RP013_UNDEFINED_VALUE, ERROR,
                     f"segment {seg.sid} reads slot {slot}, whose producer "
                     f"is neither a program node nor an input/const",
                     node=src, segment=seg.sid)
                continue
            crosses = ctx.dev(src) != seg.device
            if pos in transfer_pos and not crosses:
                emit(E.RP030_REDUNDANT_TRANSFER, WARN,
                     f"segment {seg.sid} marks input {slot} as a transfer "
                     f"but its producer already sits on pe {seg.device} — "
                     f"a self-transfer", node=src, segment=seg.sid,
                     device=seg.device)
            if crosses and pos not in transfer_pos:
                emit(E.RP012_MISSING_TRANSFER, ERROR,
                     f"segment {seg.sid} on pe {seg.device} reads slot "
                     f"{slot} from pe {ctx.dev(src)} without a transfer "
                     f"op — the compiled segment would consume a remote "
                     f"buffer", node=src, segment=seg.sid,
                     device=seg.device)
            # availability of the source value
            if not is_root:
                if slot not in produced:
                    if slot not in produced_at:
                        emit(E.RP013_UNDEFINED_VALUE, ERROR,
                             f"segment {seg.sid} consumes slot {slot} "
                             f"that no segment exports", node=src,
                             segment=seg.sid)
                    # produced later: deadlock pass owns RP010
                    continue
                if slot in freed:
                    emit(E.RP001_USE_AFTER_FREE, ERROR,
                         f"segment {seg.sid} reads slot {slot} after the "
                         f"refcount schedule freed it (producer refcount "
                         f"reached zero too early)", node=src,
                         segment=seg.sid)
                    continue
            if slot in donated:
                emit(E.RP003_BAD_DONATION, ERROR,
                     f"segment {seg.sid} reads slot {slot} after an "
                     f"earlier segment donated its buffer to XLA",
                     node=src, segment=seg.sid)
                continue
            # transfer cache, mirroring the runtime's one-copy-per-device
            if pos in transfer_pos and crosses:
                key = (slot, seg.device)
                if key in cache:
                    if pos in donate_set:
                        cache.discard(key)
                        dying_copy_bytes += _slot_bytes(ctx, slot)
                else:
                    if key in ever_transferred:
                        emit(E.RP030_REDUNDANT_TRANSFER, WARN,
                             f"slot {slot} is shipped to pe {seg.device} "
                             f"a second time (its earlier copy was "
                             f"donated or freed before this reader)",
                             node=src, segment=seg.sid, device=seg.device)
                    ever_transferred.add(key)
                    n_transfers += 1
                    alloc(seg.device, _slot_bytes(ctx, slot))
                    if pos in donate_set:
                        dying_copy_bytes += _slot_bytes(ctx, slot)
                    else:
                        cache.add(key)
                        cache_by_src.setdefault(src, []).append(key)
        # --- donation legality of same-device buffers ---------------------
        for p in sorted(donate_set):
            if p < 0 or p >= len(seg.inputs):
                continue
            slot = seg.inputs[p]
            src = slot[0]
            if p in transfer_pos and ctx.dev(src) != seg.device:
                continue    # donates the per-device copy (handled above)
            if slot in out_slot_set:
                emit(E.RP003_BAD_DONATION, ERROR,
                     f"segment {seg.sid} donates slot {slot}, which the "
                     f"program output still references", node=src,
                     segment=seg.sid)
                continue
            if src in roots:
                emit(E.RP003_BAD_DONATION, ERROR,
                     f"segment {seg.sid} donates slot {slot}, a resident "
                     f"graph input/const — the committed copy would be "
                     f"deleted", node=src, segment=seg.sid)
                continue
            if slot in donated:
                emit(E.RP003_BAD_DONATION, ERROR,
                     f"slot {slot} donated twice (again by segment "
                     f"{seg.sid})", node=src, segment=seg.sid)
                continue
            later = [j for j, _ in readers.get(slot, ()) if j > i]
            if later:
                emit(E.RP003_BAD_DONATION, ERROR,
                     f"segment {seg.sid} donates slot {slot} but "
                     f"{len(later)} later segment(s) (first: "
                     f"{segs[later[0]].sid}) still read it", node=src,
                     segment=seg.sid)
            donated.add(slot)
        # --- outputs ------------------------------------------------------
        for slot in seg.outputs:
            if slot not in produced:
                produced.add(slot)
                alloc(seg.device, _slot_bytes(ctx, slot))
        free_b(seg.device, dying_copy_bytes)
        # --- refcount-driven freeing (the runtime's exact rule) -----------
        for src in {s[0] for s in seg.inputs}:
            if src not in refcount:
                continue    # structure pass reports the table drift
            refcount[src] -= 1
            if refcount[src] < 0:
                if src not in underflowed:
                    underflowed.add(src)
                    emit(E.RP002_DOUBLE_FREE, ERROR,
                         f"refcount of node {src} underflows at segment "
                         f"{seg.sid}: more consuming segments than the "
                         f"table accounts for", node=src, segment=seg.sid)
                continue
            if refcount[src] == 0:
                for key in cache_by_src.pop(src, []):
                    if key in cache:
                        cache.discard(key)
                        free_b(key[1], _slot_bytes(ctx, key[0]))
                        n_freed += 1
                if src not in roots:
                    for slot in slots_by_producer.get(src, []):
                        if slot in produced and slot not in freed:
                            freed.add(slot)
                            free_b(ctx.dev(src), _slot_bytes(ctx, slot))
                            n_freed += 1

    # --- end state: program outputs live, nothing leaked ------------------
    for slot in out_slot_set:
        src = slot[0]
        if src in roots:
            continue
        if slot in freed:
            emit(E.RP001_USE_AFTER_FREE, ERROR,
                 f"program output slot {slot} was freed before the call "
                 f"returns", node=src)
        elif slot in donated:
            emit(E.RP003_BAD_DONATION, ERROR,
                 f"program output slot {slot} was donated before the call "
                 f"returns", node=src)
        elif src in prog_nodes and slot not in produced:
            emit(E.RP013_UNDEFINED_VALUE, ERROR,
                 f"program output slot {slot} is never exported by any "
                 f"segment", node=src)
    for src, rc in sorted(refcount.items()):
        expected = 1 if src in output_nodes else 0
        if rc > expected:
            emit(E.RP004_LEAKED_BUFFER, WARN,
                 f"node {src}: refcount ends at {rc} (expected "
                 f"{expected}) — its buffers outlive their last reader",
                 node=src)
    if cache:
        emit(E.RP004_LEAKED_BUFFER, WARN,
             f"{len(cache)} transferred cop{'y' if len(cache) == 1 else 'ies'}"
             f" never freed or donated: "
             f"{sorted(cache)[:5]}")

    res = InterpResult(
        diagnostics=diags,
        cert_peaks=peak_b.copy() if track_bytes else None,
        cert_resident=resident if track_bytes else None,
        freed_values=n_freed, transfers=n_transfers)
    ctx._interp = res
    return res


@analysis_pass("liveness")
def liveness_pass(ctx: AnalysisContext, rep: DiagnosticReport) -> None:
    """Abstract interpretation of the refcount/donation/transfer
    schedule (see :func:`abstract_interpret`)."""
    rep.extend(abstract_interpret(ctx).diagnostics)


# ---------------------------------------------------------------------------
# memory certificate
# ---------------------------------------------------------------------------
@analysis_pass("memory")
def memory_pass(ctx: AnalysisContext, rep: DiagnosticReport) -> None:
    """Per-device peak-memory certificate from the schedule alone."""
    res = abstract_interpret(ctx)
    if res.cert_peaks is None:
        return
    peaks = res.cert_peaks
    caps = ctx.mem_caps
    if caps is not None:
        caps_arr = np.broadcast_to(np.asarray(caps, dtype=np.float64),
                                   peaks.shape)
        for pe, (p, c) in enumerate(zip(peaks, caps_arr)):
            if p > c:
                sev = ERROR if ctx.feasible else WARN
                _diag(rep, E.RP020_MEMORY_CAP_OVERFLOW, sev,
                      f"device {pe}: certified peak {p:.3g} B exceeds the "
                      f"capacity {c:.3g} B the plan "
                      f"{'claims to satisfy' if ctx.feasible else 'was given (already marked infeasible)'}",
                      "memory", device=pe)
    if ctx.predicted_peaks is not None:
        pred = np.asarray(ctx.predicted_peaks, dtype=np.float64)
        for pe in range(min(len(pred), len(peaks))):
            if peaks[pe] > pred[pe] * PEAK_DRIFT_FACTOR + PEAK_DRIFT_SLACK:
                _diag(rep, E.RP021_PEAK_PREDICTION_DRIFT, WARN,
                      f"device {pe}: certified peak {peaks[pe]:.3g} B "
                      f"exceeds {PEAK_DRIFT_FACTOR}x Step-2's predicted "
                      f"{pred[pe]:.3g} B + {PEAK_DRIFT_SLACK:.3g} B — the "
                      f"emulator's memory model has drifted from the "
                      f"schedule", "memory", device=pe)


# ---------------------------------------------------------------------------
# overlap: certify the async (prefetch-at-producer) dispatch schedule
# ---------------------------------------------------------------------------
@dataclass
class OverlapInterpResult:
    """Certificate of the *async* abstract interpretation: the same
    refcount/donation/transfer replay as :func:`abstract_interpret`, but
    with every ``device_put`` issued at its producer's dispatch (the
    prefetch table) under the bounded in-flight transfer window —
    exactly ``CompiledRuntime.__call__``'s async control flow."""

    cert_peaks: np.ndarray | None       # per-device async peak bytes
    peak_inflight_bytes: float = 0.0    # live transferred-copy bytes
    prefetched: int = 0                 # copies issued at producer dispatch
    deferred: int = 0                   # prefetches pushed past the window
    window_bytes: float = 0.0


def overlap_interpret(ctx: AnalysisContext) -> OverlapInterpResult:
    """Replay the async runtime's prefetch/window/liveness schedule
    abstractly and certify per-device peaks under *prefetch-at-producer*
    buffer lifetimes. Structural table defects are the overlap pass's
    job — this replay skips unissuable entries silently, like the
    runtime's lazy fallback does. The result is cached on the context.
    """
    if ctx._overlap is not None:
        return ctx._overlap
    prog, sched = ctx.prog, ctx.schedule
    assert prog is not None and sched is not None
    window = _resolve_window(ctx.transfer_window_bytes)
    track = ctx.graph is not None and len(getattr(
        ctx.graph, "mem", [])) > 0
    k = max(ctx.k, 1)
    live = np.zeros(k)
    peak = np.zeros(k)
    inflight = 0.0
    peak_inflight = 0.0
    prefetched = 0
    deferred = 0

    def alloc(pe: int, nb: float) -> None:
        if 0 <= pe < k:
            live[pe] += nb
            peak[pe] = max(peak[pe], live[pe])

    def free_b(pe: int, nb: float) -> None:
        if 0 <= pe < k:
            live[pe] -= nb

    roots = set(prog.input_nodes) | {nid for nid, _ in prog.const_nodes}
    if track:
        for nid in list(prog.input_nodes) + [n for n, _ in prog.const_nodes]:
            alloc(ctx.dev(nid), _slot_bytes(ctx, (nid, 0))
                  * max(prog.n_outputs.get(nid, 1), 1))

    segs = sched.segments
    slots_by_producer: dict[int, list[Slot]] = {}
    for seg in segs:
        for slot in seg.outputs:
            slots_by_producer.setdefault(slot[0], []).append(slot)

    produced: set[Slot] = set()
    freed_env: set[Slot] = set()
    donated_env: set[Slot] = set()
    cache: set[tuple[Slot, int]] = set()
    cache_by_src: dict[int, list[tuple[Slot, int]]] = {}
    refcount = dict(sched.node_refcount)

    def issue_prefetch(psid: int) -> None:
        nonlocal inflight, peak_inflight, prefetched, deferred
        for slot, dst in sched.prefetch.get(psid, ()):
            if not 0 <= dst < k or ctx.dev(slot[0]) == dst:
                continue        # bad target / self-transfer: static check
            key = (slot, dst)
            if key in cache:
                continue
            if slot[0] not in roots and slot not in produced:
                continue        # not yet available: lazy fallback
            if slot in freed_env or slot in donated_env:
                continue        # RP042/consistency reported statically
            nb = _slot_bytes(ctx, slot)
            if track and inflight + nb > window:
                deferred += 1
                continue
            prefetched += 1
            alloc(dst, nb)
            inflight += nb
            peak_inflight = max(peak_inflight, inflight)
            cache.add(key)
            cache_by_src.setdefault(slot[0], []).append(key)

    issue_prefetch(-1)
    for seg in segs:
        transfer_pos = set(seg.transfer_inputs)
        donate_set = set(seg.dead_inputs)
        dying_copy_bytes = 0.0
        for pos, slot in enumerate(seg.inputs):
            if pos not in transfer_pos or ctx.dev(slot[0]) == seg.device:
                continue
            key = (slot, seg.device)
            nb = _slot_bytes(ctx, slot)
            if key in cache:
                if pos in donate_set:
                    cache.discard(key)
                    dying_copy_bytes += nb
                    inflight -= nb
            else:
                # lazy issue: window-deferred or re-shipped after a free
                alloc(seg.device, nb)
                if pos in donate_set:
                    dying_copy_bytes += nb
                else:
                    inflight += nb
                    peak_inflight = max(peak_inflight, inflight)
                    cache.add(key)
                    cache_by_src.setdefault(slot[0], []).append(key)
        for p in donate_set:
            if 0 <= p < len(seg.inputs):
                slot = seg.inputs[p]
                if p in transfer_pos and ctx.dev(slot[0]) != seg.device:
                    continue    # donates the per-device copy, not env
                donated_env.add(slot)
        for slot in seg.outputs:
            if slot not in produced:
                produced.add(slot)
                alloc(seg.device, _slot_bytes(ctx, slot))
        issue_prefetch(seg.sid)
        free_b(seg.device, dying_copy_bytes)
        for src in {s[0] for s in seg.inputs}:
            if src not in refcount:
                continue
            refcount[src] -= 1
            if refcount[src] != 0:
                continue
            for key in cache_by_src.pop(src, []):
                if key in cache:
                    cache.discard(key)
                    nb = _slot_bytes(ctx, key[0])
                    free_b(key[1], nb)
                    inflight -= nb
            if src not in roots:
                for slot in slots_by_producer.get(src, []):
                    if slot in produced and slot not in freed_env:
                        freed_env.add(slot)
                        free_b(ctx.dev(src), _slot_bytes(ctx, slot))

    res = OverlapInterpResult(
        cert_peaks=peak.copy() if track else None,
        peak_inflight_bytes=peak_inflight, prefetched=prefetched,
        deferred=deferred, window_bytes=window)
    ctx._overlap = res
    return res


def _overlap_table_checks(ctx: AnalysisContext,
                          rep: DiagnosticReport) -> None:
    """RP041/RP042: the prefetch table is issuable as written."""
    prog, sched = ctx.prog, ctx.schedule
    assert prog is not None and sched is not None
    segs = sched.segments
    roots = set(prog.input_nodes) | {nid for nid, _ in prog.const_nodes}
    sid_pos: dict[int, int] = {}
    exports: dict[int, set[Slot]] = {}
    for i, seg in enumerate(segs):
        sid_pos.setdefault(seg.sid, i)
        exports.setdefault(seg.sid, set()).update(seg.outputs)
    # first cross-device reader position per (slot, consuming pe)
    first_read: dict[tuple[Slot, int], int] = {}
    for i, seg in enumerate(segs):
        for pos in seg.transfer_inputs:
            if not 0 <= pos < len(seg.inputs):
                continue
            key = (seg.inputs[pos], seg.device)
            if key not in first_read:
                first_read[key] = i
    # positions donating a slot's *environment* buffer (same-device
    # donations — the prefetch device_put would read a deleted buffer)
    donate_pos: dict[Slot, list[int]] = {}
    for i, seg in enumerate(segs):
        transfer_pos = set(seg.transfer_inputs)
        for p in seg.dead_inputs:
            if 0 <= p < len(seg.inputs) and p not in transfer_pos:
                donate_pos.setdefault(seg.inputs[p], []).append(i)

    registered: set[tuple[Slot, int]] = set()
    for psid in sorted(sched.prefetch):
        for slot, dst in sched.prefetch[psid]:
            registered.add((slot, dst))
            if not 0 <= dst < ctx.k:
                _diag(rep, E.RP041_DISPATCH_DEADLOCK, ERROR,
                      f"prefetch of slot {slot} targets pe {dst}, outside "
                      f"[0, {ctx.k})", "overlap", node=slot[0], device=dst)
                continue
            if psid == -1:
                issue = -1
                if slot[0] not in roots:
                    _diag(rep, E.RP041_DISPATCH_DEADLOCK, ERROR,
                          f"call-start prefetch (key -1) of slot {slot}, "
                          f"which is not a graph input/const — nothing is "
                          f"available to ship at call start", "overlap",
                          node=slot[0], device=dst)
            else:
                pos = sid_pos.get(psid)
                if pos is None:
                    _diag(rep, E.RP041_DISPATCH_DEADLOCK, ERROR,
                          f"prefetch of slot {slot} to pe {dst} is keyed "
                          f"to segment {psid}, which the schedule never "
                          f"dispatches — the copy is never issued",
                          "overlap", node=slot[0], device=dst)
                    continue
                issue = pos
                if slot not in exports.get(psid, set()):
                    _diag(rep, E.RP041_DISPATCH_DEADLOCK, ERROR,
                          f"prefetch of slot {slot} is keyed to segment "
                          f"{psid}, which does not export it — issued at "
                          f"that dispatch the source may not exist yet",
                          "overlap", node=slot[0], segment=psid,
                          device=dst)
            f = first_read.get((slot, dst))
            if f is None:
                _diag(rep, E.RP030_REDUNDANT_TRANSFER, WARN,
                      f"prefetch of slot {slot} to pe {dst}: no segment "
                      f"on that device reads it as a transfer — a copy "
                      f"nothing consumes", "overlap", node=slot[0],
                      device=dst)
            elif issue >= f:
                _diag(rep, E.RP041_DISPATCH_DEADLOCK, ERROR,
                      f"prefetch of slot {slot} to pe {dst} issues at "
                      f"schedule position {issue} but its first consumer "
                      f"(segment {segs[f].sid}) dispatches at position "
                      f"{f} — the copy cannot arrive before its reader",
                      "overlap", node=slot[0], segment=segs[f].sid,
                      device=dst)
            for q in donate_pos.get(slot, ()):
                if issue >= q:
                    _diag(rep, E.RP042_OVERLAP_DONATION_HAZARD, ERROR,
                          f"prefetch of slot {slot} to pe {dst} issues at "
                          f"schedule position {issue}, but segment "
                          f"{segs[q].sid} (position {q}) donates that "
                          f"buffer to XLA — the device_put would read "
                          f"deleted memory", "overlap", node=slot[0],
                          segment=segs[q].sid, device=dst)
    # coverage lint: cross-device reads the table never prefetches
    missing = sorted(key for key in first_read
                     if key not in registered
                     and ctx.dev(key[0][0]) != segs[first_read[key]].device)
    for slot, dst in missing[:10]:
        _diag(rep, E.RP040_TRANSFER_WINDOW_EXCEEDED, INFO,
              f"cross-device read of slot {slot} on pe {dst} is never "
              f"prefetched — it always pays consumer-time transfer "
              f"latency", "overlap", node=slot[0], device=dst)
    if len(missing) > 10:
        _diag(rep, E.RP040_TRANSFER_WINDOW_EXCEEDED, INFO,
              f"... and {len(missing) - 10} more unprefetched "
              f"cross-device reads", "overlap")


@analysis_pass("overlap")
def overlap_pass(ctx: AnalysisContext, rep: DiagnosticReport) -> None:
    """Certify the async dispatch schedule: prefetch-table consistency
    (RP041), donation legality under overlap (RP042), and the async
    peak/window certificate (RP040)."""
    _overlap_table_checks(ctx, rep)
    res = overlap_interpret(ctx)
    if res.cert_peaks is None:
        return
    window = res.window_bytes
    # single transfers the window can never admit (always lazy)
    oversize = sorted({
        (slot, dst) for entries in (ctx.schedule.prefetch.values()
                                    if ctx.schedule is not None else ())
        for slot, dst in entries
        if _slot_bytes(ctx, slot) > window})
    for slot, dst in oversize[:10]:
        _diag(rep, E.RP040_TRANSFER_WINDOW_EXCEEDED, WARN,
              f"transfer of slot {slot} to pe {dst} "
              f"({_slot_bytes(ctx, slot):.3g} B) exceeds the in-flight "
              f"window ({window:.3g} B) — it can never be prefetched and "
              f"always stalls its consumer", "overlap", node=slot[0],
              device=dst)
    if res.peak_inflight_bytes > window:
        _diag(rep, E.RP040_TRANSFER_WINDOW_EXCEEDED, WARN,
              f"live transferred-copy bytes peak at "
              f"{res.peak_inflight_bytes:.3g} B, above the "
              f"{window:.3g} B window — lazy consumer-time copies are "
              f"not throttled by the window, only prefetch issue is",
              "overlap")
    caps = ctx.mem_caps
    if caps is not None:
        caps_arr = np.broadcast_to(np.asarray(caps, dtype=np.float64),
                                   res.cert_peaks.shape)
        for pe, (p, c) in enumerate(zip(res.cert_peaks, caps_arr)):
            if p > c:
                sev = ERROR if ctx.feasible else WARN
                _diag(rep, E.RP040_TRANSFER_WINDOW_EXCEEDED, sev,
                      f"device {pe}: async-certified peak {p:.3g} B "
                      f"(prefetch-at-producer lifetimes) exceeds the "
                      f"capacity {c:.3g} B the plan "
                      f"{'claims to satisfy' if ctx.feasible else 'was given (already marked infeasible)'}"
                      f" — overlapped dispatch holds transferred copies "
                      f"live earlier than the lazy schedule", "overlap",
                      device=pe)


# ---------------------------------------------------------------------------
# lints
# ---------------------------------------------------------------------------
@analysis_pass("lint")
def lint_pass(ctx: AnalysisContext, rep: DiagnosticReport) -> None:
    """RP031: dead nodes — computed, never consumed, not an output."""
    prog = ctx.prog
    assert prog is not None
    consumers, output_nodes = prog.liveness()
    dead = [nid for nid in prog.program
            if nid not in consumers and nid not in output_nodes]
    for nid in dead[:20]:
        name = str(prog.program[nid][0])
        _diag(rep, E.RP031_DEAD_NODE, INFO,
              f"node {nid} ({name}) is never consumed and is not a "
              f"program output — dead work", "lint", node=nid)
    if len(dead) > 20:
        _diag(rep, E.RP031_DEAD_NODE, INFO,
              f"... and {len(dead) - 20} more dead nodes", "lint")
