"""Step-2 stage 2: tracking memory consumption (§3.2.2, Eqn 2).

Node classes:
  * ``res_ns`` — outputs survive across iterations (variables, optimizer
    state): charged to their pe for the whole horizon.
  * ``nor_ns`` — output allocated when the node is scheduled, freed after
    its *last direct descendant on each holding pe* has started.
  * ``ref_ns`` — in-place mutators: no extra memory, must be co-located
    with the variable they mutate.

Eqn (2) charges, at time t on device pe:
  1. all residual outputs assigned to pe,
  2. outputs of normal nodes executing on pe at t,
  3. outputs still held for not-yet-executed local descendants — both for
     locally produced tensors and for copies received from other devices.

Like the emulator, the tracker has two engines behind ``engine=``:

* ``engine="scalar"`` — the reference sweep: python loops build per-pe
  (time, delta) event lists, sort, and scan.
* ``engine="vector"`` (default) — the whole profile is four numpy passes:
  a lexsort-based last-consumer reduction over the flat edge arrays, a
  batched event-table construction, one global lexsort, and segmented
  cumulative sums per device.

Deltas that share an exact timestamp are summed before the running
maximum is taken (they describe the same instant), which makes the peak
independent of event construction order — both engines therefore agree
bit-for-bit (enforced by tests/test_engine_equivalence.py).

``IncrementalMemoryTracker`` complements the batch profile: max-prefix
segment trees (``fenwick.MaxPrefixTree``) over the event timeline per
device give O(1) per-device peak queries and O(deg·log V) updates when
Step-2's knapsack moves a node — instead of an O(V+E) recomputation per
candidate move.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .graph import CostGraph, NORMAL, REF, RESIDUAL, ranges_index
from .emulator import Schedule, resolve_engine
from .fenwick import MaxPrefixTree


@dataclass
class MemoryProfile:
    peak: np.ndarray                    # per-pe peak bytes
    peak_time: np.ndarray               # time of per-pe peak
    residual: np.ndarray                # per-pe residual (always-live) bytes
    # exactly one of the two last-consumer representations is populated:
    # scalar engine: per node a dict {holding pe -> last local consumer};
    # vector engine: dense (n, k) int array, -1 where no consumer.
    last_consumer: list[dict[int, int]] | None = None
    lc: np.ndarray | None = None
    # raw events: the scalar engine keeps per-pe (time, delta) lists; the
    # vector engine keeps the flat sorted arrays it already built.
    events: list[list[tuple[float, float]]] | None = None
    ev_arrays: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None

    def last_consumer_on(self, u: int, pe: int) -> int:
        """Last local consumer (by start time) of u's output on pe; -1."""
        if self.lc is not None:
            return int(self.lc[u, pe])
        v = self.last_consumer[u].get(pe)
        return -1 if v is None else v

    def consumption_at(self, pe: int, t: float) -> float:
        """Memory consumed on ``pe`` at time t (residual + live deltas)."""
        if self.events is not None:
            s = self.residual[pe]
            for tt, d in self.events[pe]:
                if tt > t:
                    break
                s += d
            return float(s)
        ev_pe, ev_time, ev_delta = self.ev_arrays
        sel = (ev_pe == pe) & (ev_time <= t)
        return float(self.residual[pe] + np.sum(ev_delta[sel]))

    def first_overflow(self, caps: np.ndarray) -> list[tuple[int, float, float]]:
        """Per-pe (pe, time, overflow_bytes) for the *peak* overflow; empty
        if all within caps."""
        out = []
        for pe in range(len(self.peak)):
            if self.peak[pe] > caps[pe]:
                out.append((pe, float(self.peak_time[pe]),
                            float(self.peak[pe] - caps[pe])))
        return out


def _free_after(t: float) -> float:
    """Timestamp 'just after' t: the buffer is live while its last
    consumer starts (one ulp keeps alloc-at-t and free-after-t distinct
    at any magnitude, unlike a fixed epsilon)."""
    return float(np.nextafter(t, np.inf))


def compute_profile(g: CostGraph, assignment: np.ndarray, sched: Schedule,
                    k: int, engine: str | None = None) -> MemoryProfile:
    """Per-device memory profile of a schedule; dispatches on ``engine``."""
    if resolve_engine(engine) == "scalar":
        return compute_profile_scalar(g, assignment, sched, k)
    return compute_profile_vectorized(g, assignment, sched, k)


# --------------------------------------------------------------- vectorized
def _last_consumers(g: CostGraph, assignment: np.ndarray, st: np.ndarray,
                    k: int) -> np.ndarray:
    """(n, k) array: lc[u, pe] = last consumer of u's output on pe, -1 if
    none. Among equal start times the earliest edge wins (matching the
    scalar engine's strict-> update rule)."""
    n = g.n
    _, src, dst, _ = g.flat_edges()
    lc = np.full((n, k), -1, dtype=np.int64)
    m = src.size
    if m == 0:
        return lc
    pv = assignment[dst]
    # sort by (src, pv, st[dst] asc, edge id desc); the last entry of each
    # (src, pv) group is the max-st consumer, earliest edge on ties
    order = np.lexsort((-np.arange(m), st[dst], pv, src))
    s, p, d = src[order], pv[order], dst[order]
    last = np.empty(m, dtype=bool)
    last[-1] = True
    np.not_equal(s[:-1], s[1:], out=last[:-1])
    np.logical_or(last[:-1], p[:-1] != p[1:], out=last[:-1])
    lc[s[last], p[last]] = d[last]
    return lc


def _event_table(g: CostGraph, assignment: np.ndarray, sched: Schedule,
                 k: int, lc: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flat event table ``(ev_pe, ev_time, ev_delta, ev_node)`` — every
    alloc/free the schedule implies, in the scalar engine's construction
    order (node-major, alloc before free)."""
    n = g.n
    mem = np.asarray(g.mem)
    ntype = np.asarray(g.ntype)
    st, ft = sched.st, sched.ft
    pu = np.asarray(assignment, dtype=np.int64)

    has_cons = lc >= 0                                   # (n, k)
    own = np.zeros((n, k), dtype=bool)
    own[np.arange(n), pu] = True
    chargeable = (mem > 0) & (ntype != REF)
    # remote copies: any device with a consumer that isn't the home device
    remote = has_cons & ~own & chargeable[:, None]
    # local pair: normal nodes only
    local = chargeable & (ntype == NORMAL)

    nextafter = np.nextafter
    inf = np.inf

    # local events
    lu = np.flatnonzero(local)
    l_pe = pu[lu]
    l_cons = lc[lu, l_pe]
    l_free = np.where(l_cons >= 0, st[np.maximum(l_cons, 0)], ft[lu])
    # remote events
    ru, r_pe = np.nonzero(remote)
    r_cons = lc[ru, r_pe]
    r_free = st[r_cons]

    ev_pe = np.concatenate([l_pe, l_pe, r_pe, r_pe])
    ev_time = np.concatenate([st[lu], nextafter(l_free, inf),
                              ft[ru], nextafter(r_free, inf)])
    ev_delta = np.concatenate([mem[lu], -mem[lu], mem[ru], -mem[ru]])
    ev_node = np.concatenate([lu, lu, ru, ru])
    # kind: 0 = alloc, 1 = free (orders same-(node, pe, time) pairs)
    ev_kind = np.concatenate([
        np.zeros(lu.size, np.int8), np.ones(lu.size, np.int8),
        np.zeros(ru.size, np.int8), np.ones(ru.size, np.int8)])
    # scalar construction order per pe: node-major, alloc before free
    order = np.lexsort((ev_kind, ev_node, ev_time, ev_pe))
    return ev_pe[order], ev_time[order], ev_delta[order], ev_node[order]


def compute_profile_vectorized(g: CostGraph, assignment: np.ndarray,
                               sched: Schedule, k: int) -> MemoryProfile:
    n = g.n
    mem = np.asarray(g.mem)
    ntype = np.asarray(g.ntype)
    pu = np.asarray(assignment, dtype=np.int64)

    res_mask = (ntype == RESIDUAL) & (mem != 0)
    residual = np.bincount(pu[res_mask], weights=mem[res_mask],
                           minlength=k).astype(np.float64)

    lc = _last_consumers(g, pu, sched.st, k)
    ev_pe, ev_time, ev_delta, _ = _event_table(g, pu, sched, k, lc)

    peak = residual.copy()
    peak_time = np.zeros(k)
    if ev_pe.size:
        pe_bounds = np.searchsorted(ev_pe, np.arange(k + 1))
        for pe in range(k):
            lo, hi = int(pe_bounds[pe]), int(pe_bounds[pe + 1])
            if lo == hi:
                continue
            # left-fold running sum seeded with the residual baseline —
            # the exact accumulation order of the scalar scan — observed
            # only at group boundaries: deltas sharing an exact timestamp
            # describe the same instant and net out before the comparison
            run = np.cumsum(
                np.concatenate(([residual[pe]], ev_delta[lo:hi])))[1:]
            tslice = ev_time[lo:hi]
            ends = np.empty(hi - lo, dtype=bool)
            ends[-1] = True
            np.not_equal(tslice[1:], tslice[:-1], out=ends[:-1])
            gvals = run[ends]
            i = int(np.argmax(gvals))
            if gvals[i] > residual[pe]:
                peak[pe] = gvals[i]
                peak_time[pe] = tslice[ends][i]
    return MemoryProfile(peak=peak, peak_time=peak_time, residual=residual,
                         lc=lc, ev_arrays=(ev_pe, ev_time, ev_delta))


# ------------------------------------------------------------------- scalar
def compute_profile_scalar(g: CostGraph, assignment: np.ndarray,
                           sched: Schedule, k: int) -> MemoryProfile:
    """Reference sweep over nodes in id order (executable documentation)."""
    n = g.n
    mem = np.asarray(g.mem)
    ntype = np.asarray(g.ntype)
    st = sched.st

    residual = np.zeros(k)
    events: list[list[tuple[float, float]]] = [[] for _ in range(k)]

    # last consumer of each node's output per holding pe (by start time)
    last_consumer: list[dict[int, int]] = [dict() for _ in range(n)]
    for u in range(n):
        for v, _ in g.out_edges[u]:
            pv = int(assignment[v])
            cur = last_consumer[u].get(pv)
            if cur is None or st[v] > st[cur]:
                last_consumer[u][pv] = v

    for u in range(n):
        pu = int(assignment[u])
        if ntype[u] == REF:
            continue  # no extra memory (§3.2.2)
        if ntype[u] == RESIDUAL:
            residual[pu] += mem[u]
            # remote copies of residual reads: charged on the consumer pe
            # until its last local consumer starts
            for pv, v in last_consumer[u].items():
                if pv != pu and mem[u] > 0:
                    events[pv].append((sched.ft[u], mem[u]))
                    events[pv].append((_free_after(st[v]), -mem[u]))
            continue
        # normal node: allocated at st(u) on its own pe …
        if mem[u] > 0:
            free_t = max((st[v] for pv, v in last_consumer[u].items()
                          if pv == pu), default=sched.ft[u])
            events[pu].append((st[u], mem[u]))
            events[pu].append((_free_after(free_t), -mem[u]))
            # … and copies held on each remote consumer pe
            for pv, v in last_consumer[u].items():
                if pv != pu:
                    events[pv].append((sched.ft[u], mem[u]))
                    events[pv].append((_free_after(st[v]), -mem[u]))

    peak = residual.copy()
    peak_time = np.zeros(k)
    for pe in range(k):
        events[pe].sort(key=lambda e: e[0])
        cum = residual[pe]
        evs = events[pe]
        i = 0
        while i < len(evs):
            # fold every delta sharing this exact timestamp (they describe
            # the same instant), then compare once per distinct time
            t = evs[i][0]
            while i < len(evs) and evs[i][0] == t:
                cum += evs[i][1]
                i += 1
            if cum > peak[pe]:
                peak[pe] = cum
                peak_time[pe] = t
    return MemoryProfile(peak=peak, peak_time=peak_time, residual=residual,
                         last_consumer=last_consumer, events=events)


# ----------------------------------------------------------- M_pot (Table 1)
def memory_potentials(g: CostGraph, assignment: np.ndarray, sched: Schedule,
                      prof: MemoryProfile, pe: int, t: float,
                      engine: str | None = None) -> dict[int, float]:
    """M_pot(n, t) for nodes assigned to ``pe`` (Table 1).

    The memory that would be released on ``pe`` at time t if node n were
    moved elsewhere: outputs of direct ancestors executed before t for
    which n is the last local descendant, plus n's own output if n is
    executing at t, plus n's residual footprint (moving a variable moves
    its storage).
    """
    if resolve_engine(engine) == "scalar":
        return memory_potentials_scalar(g, assignment, sched, prof, pe, t)
    return memory_potentials_vectorized(g, assignment, sched, prof, pe, t)


def memory_potentials_vectorized(g: CostGraph, assignment: np.ndarray,
                                 sched: Schedule, prof: MemoryProfile,
                                 pe: int, t: float) -> dict[int, float]:
    n = g.n
    mem = np.asarray(g.mem)
    ntype = np.asarray(g.ntype)
    st, ft = sched.st, sched.ft
    pu = np.asarray(assignment, dtype=np.int64)
    on_pe = pu == pe

    base = np.where(ntype == RESIDUAL, mem,
                    np.where((st <= t) & (t <= ft), mem, 0.0))
    base = np.where(on_pe, base, 0.0)

    # held inputs: edges a -> u (u on pe, st[u] >= t) whose source a is
    # non-ref, finished by t, and has u as its last consumer on pe
    indptr_in, esrc, _ = g.csr_in()
    lc_pe = (prof.lc[:, pe] if prof.lc is not None
             else np.asarray([prof.last_consumer_on(a, pe)
                              for a in range(n)], dtype=np.int64))
    cand = np.flatnonzero(on_pe & (st >= t))
    idx, cnt = ranges_index(indptr_in, cand)
    a = esrc[idx]
    u_rep = np.repeat(cand, cnt)
    take = (ntype[a] != REF) & (ft[a] <= t) & (lc_pe[a] == u_rep)
    # fold order matches the scalar loop: own output first, then in-edges
    # in adjacency order (bincount accumulates in array order)
    ids = np.concatenate([np.flatnonzero(base != 0.0), u_rep[take]])
    vals = np.concatenate([base[base != 0.0], mem[a[take]]])
    pot = np.bincount(ids, weights=vals, minlength=n) if ids.size else \
        np.zeros(n)
    out_ids = np.flatnonzero(pot > 0)
    return {int(u): float(pot[u]) for u in out_ids}


def memory_potentials_scalar(g: CostGraph, assignment: np.ndarray,
                             sched: Schedule, prof: MemoryProfile,
                             pe: int, t: float) -> dict[int, float]:
    mem = np.asarray(g.mem)
    ntype = np.asarray(g.ntype)
    st, ft = sched.st, sched.ft
    indptr_in, esrc, _ = g.csr_in()
    pot: dict[int, float] = {}
    for u in np.where(assignment == pe)[0]:
        u = int(u)
        p = 0.0
        if ntype[u] == RESIDUAL:
            p += mem[u]
        elif st[u] <= t <= ft[u]:
            p += mem[u]
        if st[u] >= t:  # not yet executed: its held inputs would be freed
            for a in esrc[indptr_in[u]:indptr_in[u + 1]]:
                if ntype[a] == REF:
                    continue
                if prof.last_consumer_on(int(a), pe) == u and ft[a] <= t:
                    p += mem[a]
        if p > 0:
            pot[u] = float(p)
    return pot


# ------------------------------------------------- incremental peak tracking
class IncrementalMemoryTracker:
    """Exact per-device peak-memory tracking under candidate node moves.

    Built once per emulation round in O((V+E) log V): the event timeline
    is rank-indexed and every device gets a :class:`MaxPrefixTree` whose
    root holds the maximum prefix sum of its deltas — i.e. the peak above
    the residual baseline. Moving node u (schedule held fixed, as in
    §3.2.3's knapsack rounds) touches only u's own alloc/free events and
    the copy events of its direct ancestors, so :meth:`apply_move` costs
    O(deg(u) log V) — the O(Δ) interface the overflow stage uses instead
    of a full profile recomputation per move.
    """

    def __init__(self, g: CostGraph, assignment: np.ndarray, sched: Schedule,
                 k: int):
        self.g = g
        self.k = k
        self.sched = sched
        # live view: the caller's assignment array (mutated via apply_move)
        self.assignment = assignment
        n = g.n
        self.mem = np.asarray(g.mem)
        self.ntype = np.asarray(g.ntype)
        st, ft = sched.st, sched.ft
        # rank index over every timestamp an event can ever occupy
        times = np.unique(np.concatenate([
            st, ft, np.nextafter(st, np.inf), np.nextafter(ft, np.inf)]))
        self.times = times
        self.trees = [MaxPrefixTree(times.size) for _ in range(k)]
        self.residual = np.zeros(k)
        res_mask = (self.ntype == RESIDUAL) & (self.mem != 0)
        np.add.at(self.residual, assignment[res_mask], self.mem[res_mask])

        lc = _last_consumers(g, assignment, st, k)
        ev_pe, ev_time, ev_delta, _ = _event_table(g, assignment, sched, k,
                                                   lc)
        ranks = np.searchsorted(times, ev_time)
        for pe in range(k):
            sel = ev_pe == pe
            self.trees[pe].add_many(ranks[sel], ev_delta[sel])

    # -- queries -----------------------------------------------------------
    def peak(self, pe: int) -> float:
        return float(self.residual[pe] + max(0.0, self.trees[pe].max_prefix()))

    def peaks(self) -> np.ndarray:
        return np.asarray([self.peak(pe) for pe in range(self.k)])

    # -- updates -----------------------------------------------------------
    def _node_events(self, u: int) -> list[tuple[int, float, float]]:
        """Current (pe, time, delta) events owned by node u's output."""
        mem = float(self.mem[u])
        ntype = int(self.ntype[u])
        if mem <= 0 or ntype == REF:
            return []
        g, a = self.g, self.assignment
        st, ft = self.sched.st, self.sched.ft
        pu = int(a[u])
        # last consumer per device
        last: dict[int, int] = {}
        for v, _ in g.out_edges[u]:
            pv = int(a[v])
            cur = last.get(pv)
            if cur is None or st[v] > st[cur]:
                last[pv] = v
        ev: list[tuple[int, float, float]] = []
        if ntype == NORMAL:
            free_t = st[last[pu]] if pu in last else ft[u]
            ev.append((pu, float(st[u]), mem))
            ev.append((pu, _free_after(float(free_t)), -mem))
        for pv, v in last.items():
            if pv != pu:
                ev.append((pv, float(ft[u]), mem))
                ev.append((pv, _free_after(float(st[v])), -mem))
        return ev

    def _apply_events(self, ev: list[tuple[int, float, float]],
                      sign: float) -> None:
        for pe, t, d in ev:
            r = int(np.searchsorted(self.times, t))
            self.trees[pe].add(r, sign * d)

    def apply_move(self, u: int, to_pe: int) -> dict:
        """Move u to ``to_pe`` (updating the shared assignment array) and
        incrementally rebuild the affected events. Returns an undo token
        for :meth:`revert`."""
        from_pe = int(self.assignment[u])
        touched = [u] + sorted({a for a, _ in self.g.in_edges[u]
                                if self.mem[a] > 0
                                and self.ntype[a] != REF})
        old = [e for x in touched for e in self._node_events(x)]
        self.assignment[u] = to_pe
        new = [e for x in touched for e in self._node_events(x)]
        self._apply_events(old, -1.0)
        self._apply_events(new, +1.0)
        if self.ntype[u] == RESIDUAL and self.mem[u] != 0:
            self.residual[from_pe] -= self.mem[u]
            self.residual[to_pe] += self.mem[u]
        return {"node": u, "from": from_pe, "to": to_pe,
                "old": old, "new": new}

    def revert(self, token: dict) -> None:
        u = token["node"]
        self._apply_events(token["new"], -1.0)
        self._apply_events(token["old"], +1.0)
        self.assignment[u] = token["from"]
        if self.ntype[u] == RESIDUAL and self.mem[u] != 0:
            self.residual[token["to"]] -= self.mem[u]
            self.residual[token["from"]] += self.mem[u]
