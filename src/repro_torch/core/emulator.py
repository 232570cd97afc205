"""Step-2 stage 1: scheduler emulator (§3.2.1).

Emulates the TensorFlow executor: each device keeps a ready queue ordered
by (ready time, node id); a node becomes ready when all its ancestors have
executed (its in-degree reaches zero); ready nodes run one at a time per
device. Cross-device edges delay readiness by ``comm(e)``.

The emulator yields the expected start/finish time of every node under a
given placement — the temporal model both the memory tracker (stage 2)
and the makespan metric are built on. Any FIFO executor (not just TF's)
fits this model; per DESIGN.md §2 it also models our pipeline runtime at
the stage granularity.

Two interchangeable engines implement the same semantics:

* ``engine="scalar"`` — the legacy heap simulation, one event per loop
  iteration. O((V+E) log V), simple, the reference implementation.
* ``engine="vector"`` (default) — batched ready-frontier processing over
  flat numpy arrays. Each round computes a *safe horizon* T = the
  earliest possible finish of any pending node; every pending node with
  ready time < T provably cannot be overtaken by a not-yet-ready node,
  so the whole safe frontier is executed in one numpy batch: a segmented
  max-plus scan gives per-device serial start times, a vectorized CSR
  gather propagates readiness to successors. Python overhead drops from
  O(V + E) heap operations to O(rounds × devices).

Both engines produce bit-for-bit identical schedules whenever event times
don't tie exactly (guaranteed for graphs with positive costs); the
equivalence is enforced by tests/test_engine_equivalence.py.

A third engine, :func:`emulate_overlap`, refines the model for the
*async* runtime: each device additionally owns an outgoing **comm
queue** (a FIFO channel, ``DeviceModel.comm_streams`` wide) that
cross-device edges occupy serially in entry order — compute and
transfers overlap, but transfers out of one device contend with each
other. ``emulate`` remains the infinite-bandwidth classic model; the
overlap engine is what `accuracy_report` scores the measured async
timeline against.

The vectorized engine reuses preallocated per-thread scratch buffers
(the pending ready-frontier, in-degrees, and the ``_serial_scan``
temporaries) across calls — repeated emulation (`plan.retune()`-style
search loops) no longer reallocates its hot arrays every call.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import heapq

import numpy as np

from ..obs.spans import span as _span
from .graph import CostGraph, ranges_index, scatter_max

#: Default Step-2 engine when neither ``engine=`` nor the
#: ``REPRO_STEP2_ENGINE`` environment variable ("vector" | "scalar") is set.
DEFAULT_ENGINE = "vector"


def resolve_engine(engine: str | None) -> str:
    # read the environment at call time so the documented global override
    # also works when set after import
    eng = engine or os.environ.get("REPRO_STEP2_ENGINE", DEFAULT_ENGINE)
    if eng not in ("vector", "scalar"):
        raise ValueError(f"unknown Step-2 engine {eng!r} "
                         "(expected 'vector' or 'scalar')")
    return eng


@dataclass
class Schedule:
    st: np.ndarray            # start times
    ft: np.ndarray            # finish times
    makespan: float
    exec_order: np.ndarray    # nodes sorted by (st, id)
    pe_busy: np.ndarray       # per-pe total busy time


@dataclass
class OverlapSchedule(Schedule):
    """Schedule under the overlap model, plus per-node queue occupancy.

    ``ready`` is when each node's last input arrived (after any comm
    delay *and* comm-queue contention); ``queue_wait = st - ready`` is
    the time the node sat in its device's compute queue — the per-node
    occupancy the async runtime's measured timeline is compared to.
    ``comm_busy`` is each device's outgoing-channel busy seconds.
    """
    ready: np.ndarray = None          # type: ignore[assignment]
    queue_wait: np.ndarray = None     # type: ignore[assignment]
    comm_busy: np.ndarray = None      # type: ignore[assignment]


def emulate(g: CostGraph, assignment: np.ndarray, k: int,
            comm_scale: float = 1.0, engine: str | None = None) -> Schedule:
    """Emulate the FIFO executor; dispatches on ``engine``."""
    eng = resolve_engine(engine)
    with _span("emulator/emulate"):
        if eng == "scalar":
            return emulate_scalar(g, assignment, k, comm_scale)
        return emulate_vectorized(g, assignment, k, comm_scale)


# --------------------------------------------------------------- vectorized
class _EmulatorScratch:
    """Per-thread reusable buffers for the vectorized engine.

    ``emulate_vectorized`` is the hot inner call of repeated-emulation
    loops (retune/search); these buffers — the pending ready-frontier
    heap, the per-node ready/in-degree arrays, and the ``_serial_scan``
    temporaries — are preallocated once and grown geometrically, so
    repeated calls stop paying per-call allocation. Arrays that escape
    into the returned :class:`Schedule` (``st``/``ft``/``exec_order``)
    are still freshly allocated — results from earlier calls must stay
    valid.
    """

    def __init__(self) -> None:
        self._f64: dict[str, np.ndarray] = {}
        self._i64: dict[str, np.ndarray] = {}
        self._bool: dict[str, np.ndarray] = {}

    @staticmethod
    def _take(pool: dict, name: str, m: int, dtype) -> np.ndarray:
        buf = pool.get(name)
        if buf is None or buf.size < m:
            cap = 1 << max(int(m) - 1, 0).bit_length()
            buf = np.empty(max(cap, 16), dtype=dtype)
            pool[name] = buf
        return buf[:m]

    def f64(self, name: str, m: int) -> np.ndarray:
        return self._take(self._f64, name, m, np.float64)

    def i64(self, name: str, m: int) -> np.ndarray:
        return self._take(self._i64, name, m, np.int64)

    def boolean(self, name: str, m: int) -> np.ndarray:
        return self._take(self._bool, name, m, bool)


_TLS = threading.local()


def _scratch() -> _EmulatorScratch:
    scr = getattr(_TLS, "scratch", None)
    if scr is None:
        scr = _TLS.scratch = _EmulatorScratch()
    return scr


def _serial_scan(r: np.ndarray, c: np.ndarray, free: float,
                 scr: _EmulatorScratch | None = None) -> np.ndarray:
    """Exact serial-device scan: ft_i = max(ft_{i-1}, r_i) + c_i, ft_{-1}=free.

    Bit-for-bit identical to the scalar engine's event loop: a closed-form
    max-plus prefix pass locates the idle-gap "runs" (maximal stretches
    with no reset, where ft is a plain left-fold cumsum), each run is then
    summed with ``np.cumsum`` — the same left-to-left-fold order the scalar
    loop uses — and the reset predictions are verified against the exact
    values (a mispredict can only happen when r_i ties ft_{i-1} within one
    ulp; we then fall back to the plain sequential loop).

    The returned array lives in ``scr`` (when given) and is only valid
    until the next ``_serial_scan`` call on the same scratch — callers
    copy it out (``ft[ids] = ...``) before re-entering.
    """
    m = r.size
    scr = scr or _scratch()
    if m == 1:
        out = scr.f64("scan_ft", 1)
        out[0] = max(free, r[0]) + c[0]
        return out
    # closed-form estimate: ft_i ≈ C_i + max(free, max_{j<=i}(r_j − C_{j-1}))
    csum = scr.f64("scan_csum", m)
    np.cumsum(c, out=csum)
    approx = scr.f64("scan_approx", m)
    np.subtract(csum, c, out=approx)          # csum - c
    np.subtract(r, approx, out=approx)        # r - (csum - c)
    np.maximum.accumulate(approx, out=approx)
    np.maximum(approx, free, out=approx)
    approx += csum
    resets = scr.boolean("scan_resets", m)
    resets[0] = True
    np.greater(r[1:], approx[:-1], out=resets[1:])
    ft = scr.f64("scan_ft", m)
    v = scr.f64("scan_v", m)
    starts = np.flatnonzero(resets)
    prev = free
    for si in range(starts.size):
        lo = starts[si]
        hi = starts[si + 1] if si + 1 < starts.size else m
        vv = v[lo:hi]
        vv[:] = c[lo:hi]
        vv[0] = max(prev, r[lo]) + c[lo]
        np.cumsum(vv, out=ft[lo:hi])
        prev = ft[hi - 1]
    # position 0 is exact by construction; verify the predicted resets
    if np.array_equal(r[1:] > ft[:-1], resets[1:]):
        return ft
    # ulp-level tie flipped a reset decision: sequential fallback
    prev = free
    for i in range(m):
        prev = max(prev, r[i]) + c[i]
        ft[i] = prev
    return ft


def emulate_vectorized(g: CostGraph, assignment: np.ndarray, k: int,
                       comm_scale: float = 1.0) -> Schedule:
    """Batched ready-frontier emulation.

    Invariant: any node that becomes ready in the future has ready time
    ≥ T = min over pending nodes of (max(ready, pe_free) + comp), because
    it descends from some pending node and readiness is monotone in finish
    times. Hence all pending nodes with ready < T can be committed now in
    (ready, id) order per device without risk of reordering.
    """
    n = g.n
    if n == 0:
        return Schedule(st=np.zeros(0), ft=np.zeros(0), makespan=0.0,
                        exec_order=np.zeros(0, dtype=np.int64),
                        pe_busy=np.zeros(k))
    comp = np.asarray(g.comp, dtype=np.float64)
    assignment = np.asarray(assignment, dtype=np.int64)
    indptr, dst, w = g.csr_out()
    scr = _scratch()
    indeg = scr.i64("indeg", n)
    np.copyto(indeg, g.in_degrees())

    ready = scr.f64("ready", n)
    ready.fill(0.0)
    st = np.zeros(n)
    ft = np.zeros(n)
    pe_free = np.zeros(k)
    pe_busy = np.zeros(k)

    # the pending ready-frontier lives in one preallocated buffer: each
    # node enters it exactly once, so capacity n bounds occupancy
    pend_buf = scr.i64("pend", n)
    roots = np.flatnonzero(indeg == 0)
    n_pend = roots.size
    pend_buf[:n_pend] = roots
    done = 0
    while n_pend:
        pend = pend_buf[:n_pend]
        pr = ready[pend]
        pdev = assignment[pend]
        # safe horizon: earliest possible finish among pending nodes
        T = float(np.min(np.maximum(pr, pe_free[pdev]) + comp[pend]))
        safe = pr < T
        if not safe.any():
            # degenerate tie (zero-cost nodes): commit the single minimal
            # (ready, id) pending node to guarantee progress
            i = int(np.lexsort((pend, pr))[0])
            safe[i] = True
        batch = pend[safe]
        keep = pend[~safe]
        n_pend = keep.size
        pend_buf[:n_pend] = keep

        # per-device serial schedule in (ready, id) order
        order = np.lexsort((batch, ready[batch], assignment[batch]))
        batch = batch[order]
        bdev = assignment[batch]
        bready = ready[batch]
        bcomp = comp[batch]
        segmask = np.empty(len(batch), dtype=bool)
        segmask[0] = True
        np.not_equal(bdev[1:], bdev[:-1], out=segmask[1:])
        seg = np.flatnonzero(segmask)
        for si in range(seg.size):
            lo = seg[si]
            hi = seg[si + 1] if si + 1 < seg.size else len(batch)
            d = int(bdev[lo])
            c = bcomp[lo:hi]
            r = bready[lo:hi]
            ftb = _serial_scan(r, c, pe_free[d], scr)
            ids = batch[lo:hi]
            ft[ids] = ftb
            # st_i = max(ready_i, ft_{i-1}) — exact, matching the scalar
            # engine's arithmetic (ftb - c would differ in the last ulp)
            stb = scr.f64("stb", hi - lo)
            stb[0] = max(pe_free[d], r[0])
            np.maximum(r[1:], ftb[:-1], out=stb[1:])
            st[ids] = stb
            pe_free[d] = ftb[-1]
        done += batch.size

        # propagate readiness to successors (vectorized CSR gather)
        idx, cnt = ranges_index(indptr, batch)
        if idx.size:
            ch = dst[idx]
            src = np.repeat(batch, cnt)
            delay = np.where(assignment[ch] != assignment[src],
                             w[idx] * comm_scale, 0.0)
            scatter_max(ready, ch, ft[src] + delay)
            indeg -= np.bincount(ch, minlength=n)
            uch = np.unique(ch)
            newly = uch[indeg[uch] == 0]
            if newly.size:
                pend_buf[n_pend:n_pend + newly.size] = newly
                n_pend += newly.size
    assert done == n, "emulator stalled: graph has a cycle or bad in-degrees"

    makespan = float(np.max(ft)) if n else 0.0
    exec_order = np.lexsort((np.arange(n), st))
    # per-device busy time: left-fold in execution order, matching the
    # scalar engine's accumulation order bit-for-bit
    adev = assignment[exec_order]
    acomp = comp[exec_order]
    for d in range(k):
        cd = acomp[adev == d]
        if cd.size:
            pe_busy[d] = np.cumsum(cd)[-1]
    return Schedule(st=st, ft=ft, makespan=makespan, exec_order=exec_order,
                    pe_busy=pe_busy)


# ------------------------------------------------------------------- scalar
def emulate_scalar(g: CostGraph, assignment: np.ndarray, k: int,
                   comm_scale: float = 1.0) -> Schedule:
    """Reference event-loop emulation, one node per iteration.

    Each device keeps a heap of pending nodes keyed by (ready, id); every
    step executes the head whose start time ``max(pe_free, ready)`` is
    globally minimal — the device-order race the vectorized engine batches.
    O(V·(k + log V) + E); kept for equivalence testing and as executable
    documentation of the semantics.
    """
    n = g.n
    comp = np.asarray(g.comp)
    st = np.zeros(n)
    ft = np.zeros(n)
    indeg = np.zeros(n, dtype=np.int64)
    ready_at = np.zeros(n)
    for u in range(n):
        for v, _ in g.out_edges[u]:
            indeg[v] += 1

    # per-pe queue: heap keyed by (ready_time, node id) — nodes are enqueued
    # the moment they become ready and run in (ready, id) order.
    queues: list[list[tuple[float, int]]] = [[] for _ in range(k)]
    for u in range(n):
        if indeg[u] == 0:
            heapq.heappush(queues[assignment[u]], (0.0, u))

    pe_free = np.zeros(k)
    pe_busy = np.zeros(k)
    pending = n
    while pending:
        # advance the device that can start its head task earliest
        pe, t_best = -1, np.inf
        for d in range(k):
            if queues[d]:
                t = max(pe_free[d], queues[d][0][0])
                if t < t_best:
                    pe, t_best = d, t
        r, u = heapq.heappop(queues[pe])
        st[u] = max(pe_free[pe], r)
        ft[u] = st[u] + comp[u]
        pe_free[pe] = ft[u]
        pe_busy[pe] += comp[u]
        pending -= 1
        for v, c in g.out_edges[u]:
            delay = c * comm_scale if assignment[v] != pe else 0.0
            ready_at[v] = max(ready_at[v], ft[u] + delay)
            indeg[v] -= 1
            if indeg[v] == 0:
                heapq.heappush(queues[assignment[v]], (ready_at[v], v))

    makespan = float(np.max(ft)) if n else 0.0
    order = np.lexsort((np.arange(n), st))
    return Schedule(st=st, ft=ft, makespan=makespan, exec_order=order,
                    pe_busy=pe_busy)


# ------------------------------------------------------------------ overlap
def emulate_overlap(g: CostGraph, assignment: np.ndarray, k: int,
                    comm_scale: float = 1.0,
                    comm_streams: int = 1) -> OverlapSchedule:
    """FIFO executor with per-device outgoing comm queues (async model).

    Refines :func:`emulate` for the overlapped runtime: a cross-device
    edge does not merely delay its consumer by ``comm(e)`` — it occupies
    the producer device's outgoing comm channel for ``comm(e)`` seconds,
    serialized in entry order (entry = producer finish time) across
    ``comm_streams`` parallel channels (1 = the paper's single comm FIFO
    per device). Compute and communication overlap freely; transfers out
    of one device contend with each other.

    Event loop invariant (same as the scalar engine): the globally
    earliest-starting action — a compute-queue head or a comm-queue
    head — is committed each step, so committed start times are
    nondecreasing and no later-arriving comm request can precede an
    already-started one in its FIFO.

    Provable bounds (pinned by the property tests):

    * ``makespan <= serialized_makespan(...)`` — some resource is busy
      at every instant before the makespan;
    * ``makespan >= max(pe_busy)`` — each device serializes its compute;
    * with ``comm_scale == 0`` the result equals ``emulate(...)``.
    """
    with _span("emulator/emulate_overlap"):
        return _emulate_overlap(g, assignment, k, comm_scale,
                                comm_streams)


def _emulate_overlap(g: CostGraph, assignment: np.ndarray, k: int,
                     comm_scale: float = 1.0,
                     comm_streams: int = 1) -> OverlapSchedule:
    n = g.n
    streams = max(int(comm_streams), 1)
    if n == 0:
        z = np.zeros(0)
        return OverlapSchedule(
            st=z, ft=z.copy(), makespan=0.0,
            exec_order=np.zeros(0, dtype=np.int64), pe_busy=np.zeros(k),
            ready=z.copy(), queue_wait=z.copy(), comm_busy=np.zeros(k))
    comp = np.asarray(g.comp, dtype=np.float64)
    assignment = np.asarray(assignment, dtype=np.int64)
    st = np.zeros(n)
    ft = np.zeros(n)
    ready = np.zeros(n)
    ready_at = np.zeros(n)
    indeg = np.zeros(n, dtype=np.int64)
    for u in range(n):
        for v, _ in g.out_edges[u]:
            indeg[v] += 1

    comp_q: list[list[tuple[float, int]]] = [[] for _ in range(k)]
    # comm task: (entry time = producer ft, seq, dst node, duration)
    comm_q: list[list[tuple[float, int, int, float]]] = \
        [[] for _ in range(k)]
    for u in range(n):
        if indeg[u] == 0:
            heapq.heappush(comp_q[assignment[u]], (0.0, u))

    pe_free = np.zeros(k)
    pe_busy = np.zeros(k)
    comm_free = np.zeros((k, streams))
    comm_busy = np.zeros(k)
    seq = 0
    pending = n

    def arrive(v: int, t: float) -> None:
        if t > ready_at[v]:
            ready_at[v] = t
        indeg[v] -= 1
        if indeg[v] == 0:
            heapq.heappush(comp_q[assignment[v]], (ready_at[v], v))

    while pending or any(comm_q):
        # next action = globally earliest start among all queue heads;
        # deterministic tie-break: compute before comm, then device id
        best = None        # (t, kind, d) with kind 0=compute, 1=comm
        for d in range(k):
            if comp_q[d]:
                t = max(pe_free[d], comp_q[d][0][0])
                cand = (t, 0, d)
                if best is None or cand < best:
                    best = cand
            if comm_q[d]:
                t = max(float(np.min(comm_free[d])), comm_q[d][0][0])
                cand = (t, 1, d)
                if best is None or cand < best:
                    best = cand
        assert best is not None, \
            "overlap emulator stalled: cycle or bad in-degrees"
        t, kind, d = best
        if kind == 0:
            r, u = heapq.heappop(comp_q[d])
            ready[u] = r
            st[u] = t
            ft[u] = t + comp[u]
            pe_free[d] = ft[u]
            pe_busy[d] += comp[u]
            pending -= 1
            for v, c in g.out_edges[u]:
                if assignment[v] != d and comm_scale > 0.0 and c > 0.0:
                    heapq.heappush(
                        comm_q[d], (ft[u], seq, v, c * comm_scale))
                    seq += 1
                else:
                    arrive(v, ft[u])
        else:
            enq, _, v, dur = heapq.heappop(comm_q[d])
            sidx = int(np.argmin(comm_free[d]))
            fin = max(comm_free[d][sidx], enq) + dur
            comm_free[d][sidx] = fin
            comm_busy[d] += dur
            arrive(v, fin)

    makespan = float(np.max(ft)) if n else 0.0
    order = np.lexsort((np.arange(n), st))
    return OverlapSchedule(st=st, ft=ft, makespan=makespan,
                           exec_order=order, pe_busy=pe_busy,
                           ready=ready, queue_wait=st - ready,
                           comm_busy=comm_busy)


def serialized_makespan(g: CostGraph, assignment: np.ndarray,
                        comm_scale: float = 1.0) -> float:
    """Makespan if nothing overlapped: every compute and every
    cross-device transfer executed one at a time, globally — the
    upper bound the sync runtime realizes and the overlap engine must
    stay under."""
    a = np.asarray(assignment, dtype=np.int64)
    total = float(np.sum(np.asarray(g.comp, dtype=np.float64)))
    indptr, dst, w = g.csr_out()
    if dst.size:
        src = np.repeat(np.arange(g.n), np.diff(indptr))
        cross = a[dst] != a[src]
        total += float(np.sum(w[cross])) * comm_scale
    return total


def segment_cost_graph(prog, sched, g: CostGraph,
                       device_model) -> tuple[CostGraph, np.ndarray]:
    """Lift a segment schedule (the reference's
    ``core/segments.py`` ``SegmentSchedule``; not ported yet) to a
    segment-level cost graph for the overlap engine.

    One node per segment (comp = sum of member-node comp from ``g``);
    one edge per consumed cross-segment slot, weighted by the modeled
    transfer seconds of the slot's bytes when producer and consumer
    sit on different devices (0 for same-device segment dataflow).
    ``emulate_overlap`` on this graph predicts the async runtime's
    makespan; :func:`serialized_makespan` predicts the sync runtime's.
    """
    mem = np.asarray(g.mem, dtype=np.float64)
    comp = np.asarray(g.comp, dtype=np.float64)
    sg = CostGraph()
    for seg in sched.segments:
        sg.add_node(comp=float(np.sum(comp[list(seg.nodes)])),
                    name=f"seg{seg.sid}")
    # comm seconds per (producer seg, consumer seg) pair: the runtime
    # issues one device_put per (slot, target device), consumed by the
    # *first* reader there (later readers hit the transfer cache), so
    # each transfer's seconds are charged to its first-consumer edge;
    # per-slot link latency is preserved by summing per-slot costs
    comm_of: dict[tuple[int, int], float] = {}
    first_reader: set[tuple[tuple[int, int], int]] = set()
    deps: set[tuple[int, int]] = set()
    for seg in sched.segments:
        for slot in seg.inputs:
            psid = sched.producer_seg.get(slot, -1)
            if psid < 0 or psid == seg.sid:
                continue
            pair = (psid, seg.sid)
            deps.add(pair)
            if sched.segments[psid].device == seg.device:
                continue
            xkey = (slot, seg.device)
            if xkey in first_reader:
                continue            # cached copy: no second transfer
            first_reader.add(xkey)
            n_out = prog.n_outputs.get(slot[0], 1)
            nb = float(mem[slot[0]]) / max(n_out, 1)
            comm_of[pair] = comm_of.get(pair, 0.0) + \
                device_model.transfer_seconds(nb)
    for psid, sid in sorted(deps):
        sg.add_edge(psid, sid, comm=comm_of.get((psid, sid), 0.0))
    sg.finalize()
    assignment = np.asarray([seg.device for seg in sched.segments],
                            dtype=np.int64)
    return sg, assignment
