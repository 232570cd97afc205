"""Stage-II mapping (paper Algorithm 2).

1. *Initial merge*: a secondary cluster whose communication cannot be hidden
   by the parallel work available within its span — ``comm(sc) −
   potential(sc) > 0`` — has no parallelism gain; merge it into the primary
   cluster it communicates with the most.
2. *LALB* (Level-Aware Load Balancing, the paper's novel heuristic): merge
   each remaining secondary into the primary minimizing Eqn (1):
   work already mapped to that pe *within the cluster's span* plus the
   cut communication the merge would leave behind. Work-in-span queries are
   O(log |V|) via per-pe Fenwick trees indexed by level; ties break toward
   the pe with the highest communication with the cluster.

Interpretation choices (the paper defines terms in prose):
  * span(sc) = [ max_{p∈parents(first(sc))} (tl(p)+comp(p)),
                 min_{c∈children(last(sc))} tl(c) ]   (Table 1, "span")
    with graph start/end as fallbacks when the cluster has no parents /
    children.
  * potential(sc) = sum of comp(u) over nodes u ∉ sc whose execution window
    [tl(u), tl(u)+comp(u)] fits inside span(sc), divided by K — i.e. the
    average per-pe parallel work available to hide sc's communication.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..obs.spans import traced as _traced
from .fenwick import Fenwick, LevelIndex
from .graph import CostGraph, ranges_index
from .slicing import Slicing


@dataclass
class Mapping:
    assignment: np.ndarray           # node -> pe
    cluster_of: np.ndarray           # node -> original cluster id (for refinement)
    secondary_pe: dict[int, int]     # secondary cluster idx -> pe it merged into
    spans: dict[int, tuple[float, float]]
    stats: dict = field(default_factory=dict)


def _cluster_span(g: CostGraph, tl: np.ndarray, comp: np.ndarray,
                  cluster: list[int], horizon: float) -> tuple[float, float]:
    first, last = cluster[0], cluster[-1]
    parents = [u for u, _ in g.in_edges[first]]
    children = [v for v, _ in g.out_edges[last]]
    start = max((tl[p] + comp[p] for p in parents), default=0.0)
    end = min((tl[c] for c in children), default=horizon)
    if end < start:  # degenerate span: fall back to the cluster's own window
        end = start + sum(comp[x] for x in cluster)
    return float(start), float(end)


def _cluster_edge_index(g: CostGraph, cluster) -> tuple:
    """Flat CSR gathers for a cluster's incident edges: the neighbor and
    weight arrays of all out-edges then all in-edges of its nodes — the
    vectorized replacement for ``for u in cluster: adj[u]`` loops."""
    cl = np.asarray(cluster, dtype=np.int64)
    indptr_out, dst, w_out = g.csr_out()
    indptr_in, src, w_in = g.csr_in()
    oi, _ = ranges_index(indptr_out, cl)
    ii, _ = ranges_index(indptr_in, cl)
    return dst[oi], w_out[oi], src[ii], w_in[ii]


def _cluster_comm(g: CostGraph, in_sc: np.ndarray, cluster: list[int]) -> float:
    """comm(sc): total communication of edges with exactly one end in sc."""
    dst, w_out, src, w_in = _cluster_edge_index(g, cluster)
    return float(np.sum(w_out, where=~in_sc[dst])
                 + np.sum(w_in, where=~in_sc[src]))


def _comm_per_pe(g: CostGraph, assignment: np.ndarray, cluster: list[int],
                 k: int) -> np.ndarray:
    """Communication between sc and nodes currently assigned to each pe."""
    dst, w_out, src, w_in = _cluster_edge_index(g, cluster)
    pe = np.concatenate([assignment[dst], assignment[src]])
    w = np.concatenate([w_out, w_in])
    mask = pe >= 0
    return np.bincount(pe[mask], weights=w[mask], minlength=k)[:k] \
        .astype(np.float64)


def _cluster_comm_scalar(g: CostGraph, in_sc: np.ndarray,
                         cluster: list[int]) -> float:
    """Reference implementation of :func:`_cluster_comm` (python edge
    loops) — kept as the executable spec the CSR gather is pinned to
    by ``tests/test_engine_equivalence.py``."""
    tot = 0.0
    for u in cluster:
        for v, c in g.out_edges[u]:
            if not in_sc[v]:
                tot += c
        for p, c in g.in_edges[u]:
            if not in_sc[p]:
                tot += c
    return tot


def _comm_per_pe_scalar(g: CostGraph, assignment: np.ndarray,
                        cluster: list[int], k: int) -> np.ndarray:
    """Reference implementation of :func:`_comm_per_pe`."""
    out = np.zeros(k)
    for u in cluster:
        for v, c in g.out_edges[u]:
            pe = assignment[v]
            if pe >= 0:
                out[pe] += c
        for p, c in g.in_edges[u]:
            pe = assignment[p]
            if pe >= 0:
                out[pe] += c
    return out


@_traced("partition/map_lalb")
def map_clusters(g: CostGraph, s: Slicing) -> Mapping:
    n, k = g.n, s.k
    comp = np.asarray(g.comp)
    tl = s.tl
    horizon = float(np.max(s.tl + s.bl)) if n else 0.0

    assignment = np.full(n, -1, dtype=np.int64)
    cluster_of = np.full(n, -1, dtype=np.int64)
    for pe, cl in enumerate(s.primaries):
        for u in cl:
            assignment[u] = pe
            cluster_of[u] = pe
    for ci, cl in enumerate(s.secondaries):
        for u in cl:
            cluster_of[u] = k + ci

    # Level index + per-pe Fenwick trees over levels, seeded with primaries.
    lidx = LevelIndex(tl)
    bits = [Fenwick(lidx.n) for _ in range(k)]
    node_rank = np.searchsorted(lidx.levels, tl)
    for pe, cl in enumerate(s.primaries):
        for u in cl:
            bits[pe].add(int(node_rank[u]), comp[u])

    in_sc = np.zeros(n, dtype=bool)
    spans: dict[int, tuple[float, float]] = {}
    secondary_pe: dict[int, int] = {}

    # Pre-compute spans and potentials against the *original* level
    # structure. Two regimes:
    #   small graphs — exact "fits entirely within the span" filter
    #   (O(window) per query; best LALB quality);
    #   paper-scale graphs — O(log n) prefix sums over comp ordered by tl
    #   (keeps the paper's O(|V| log |V|) mapping bound; measured 119 s at
    #   154k nodes where the exact filter is O(|V|²) and times out).
    order = np.argsort(tl, kind="stable")
    tl_sorted = tl[order]
    end_sorted = (tl + comp)[order]
    comp_sorted = comp[order]
    comp_prefix = np.concatenate(
        [[0.0], np.cumsum(comp_sorted, dtype=np.float64)])
    use_exact = n <= 20_000

    def potential(cluster: list[int], start: float, end: float) -> float:
        lo = int(np.searchsorted(tl_sorted, start, side="left"))
        hi = int(np.searchsorted(tl_sorted, end, side="right"))
        if hi <= lo:
            return 0.0
        if use_exact:
            sl = slice(lo, hi)
            ok = end_sorted[sl] <= end
            ids = order[sl][ok]
            mask = ~in_sc[ids]
            return float(np.sum(comp_sorted[sl][ok][mask])) / max(k, 1)
        total = float(comp_prefix[hi] - comp_prefix[lo])
        own = sum(float(comp[u]) for u in cluster
                  if start <= tl[u] <= end)
        return max(total - own, 0.0) / max(k, 1)

    num_initial_merged = 0
    remaining: list[int] = []

    # ---- initial merging (Alg. 2 lines 1-7) ------------------------------
    for ci, cl in enumerate(s.secondaries):
        for u in cl:
            in_sc[u] = True
        start, end = _cluster_span(g, tl, comp, cl, horizon)
        spans[ci] = (start, end)
        c_total = _cluster_comm(g, in_sc, cl)
        pot = potential(cl, start, end)
        if c_total - pot > 0:
            comms = _comm_per_pe(g, assignment, cl, k)
            target = int(np.argmax(comms))
            for u in cl:
                assignment[u] = target
                bits[target].add(int(node_rank[u]), comp[u])
            secondary_pe[ci] = target
            num_initial_merged += 1
        else:
            remaining.append(ci)
        for u in cl:
            in_sc[u] = False

    # ---- LALB (Alg. 2 lines 8-15) ----------------------------------------
    # heaviest clusters first (Appendix A: sort by weight before LALB)
    remaining.sort(key=lambda ci: -sum(comp[u] for u in s.secondaries[ci]))
    for ci in remaining:
        cl = s.secondaries[ci]
        start, end = spans[ci]
        lo = lidx.lo_rank(start)
        hi = lidx.hi_rank(end)
        work = np.array([bits[pe].range_sum(lo, hi) for pe in range(k)])
        comms = _comm_per_pe(g, assignment, cl, k)
        total_c = float(np.sum(comms))
        # Eqn (1): work in span + communication left with *other* pes
        score = work + (total_c - comms)
        best = float(np.min(score))
        cand = np.where(np.isclose(score, best, rtol=1e-12, atol=1e-12))[0]
        # tie-break: highest communication with the cluster
        target = int(cand[np.argmax(comms[cand])])
        for u in cl:
            assignment[u] = target
            bits[target].add(int(node_rank[u]), comp[u])
        secondary_pe[ci] = target

    assert (assignment >= 0).all()
    return Mapping(assignment=assignment, cluster_of=cluster_of,
                   secondary_pe=secondary_pe, spans=spans,
                   stats={"initial_merged": num_initial_merged,
                          "lalb_merged": len(remaining)})


@_traced("partition/map_glb")
def glb_map(g: CostGraph, s: Slicing) -> Mapping:
    """Baseline: Guided Load Balancing (Radulescu & van Gemund) —
    global (non-temporal) load balancing, communication ignored (§3.1.2's
    critique). Used by benchmarks and the LC baseline."""
    n, k = g.n, s.k
    comp = np.asarray(g.comp)
    assignment = np.full(n, -1, dtype=np.int64)
    cluster_of = np.full(n, -1, dtype=np.int64)
    loads = np.zeros(k)
    for pe, cl in enumerate(s.primaries):
        for u in cl:
            assignment[u] = pe
            cluster_of[u] = pe
        loads[pe] += sum(comp[u] for u in cl)
    clusters = sorted(range(len(s.secondaries)),
                      key=lambda ci: -sum(comp[u] for u in s.secondaries[ci]))
    secondary_pe: dict[int, int] = {}
    for ci in clusters:
        cl = s.secondaries[ci]
        target = int(np.argmin(loads))
        for u in cl:
            assignment[u] = target
            cluster_of[u] = s.k + ci
        loads[target] += sum(comp[u] for u in cl)
        secondary_pe[ci] = target
    return Mapping(assignment=assignment, cluster_of=cluster_of,
                   secondary_pe=secondary_pe, spans={},
                   stats={"glb": True})
