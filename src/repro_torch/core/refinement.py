"""Stage-III refinement (§3.1.3).

Policy 1 — coarse, cluster level: look for a pair of secondary clusters
(sc on pe_a, sc' on pe_b) with overlapping spans whose assignment swap
improves load balance and/or total cut communication. Swapped pairs are
marked and not revisited (Appendix A).

Policy 2 — fine, node level: the McCreary critical-path pathology fix.
After partitioning, intra-cluster communication is free, so the CP of the
*partitioned* graph differs from the original. Repeatedly (≤ K rounds,
since each needs a level recompute) find the partitioned CP and try to
switch one endpoint of a cross-pe CP edge to the other side; keep the
switch if it shortens the CP.
"""
from __future__ import annotations

import numpy as np

from .graph import CostGraph
from .mapping import Mapping


def _partitioned_edge_w(g: CostGraph, assignment: np.ndarray,
                        group_by_dst: bool) -> np.ndarray | None:
    """Partitioned edge costs (cross-pe = comm(e), intra-pe = 0) in the
    cached sweep order of ``CostGraph._edges_by_src_depth``."""
    if g.num_edges == 0:
        return None
    s, t, ww = g._edges_by_src_depth(group_by_dst)[:3]
    return np.where(assignment[s] != assignment[t], ww, 0.0)


def _partitioned_top_levels(g: CostGraph, assignment: np.ndarray
                            ) -> np.ndarray:
    """tl under partitioned costs — the shared level sweep with
    assignment-masked edge weights."""
    return g._tl_sweep(_partitioned_edge_w(g, assignment, True), None)


def _partitioned_bottom_levels(g: CostGraph, assignment: np.ndarray
                               ) -> np.ndarray:
    """bl under partitioned costs — one batched reverse level sweep."""
    return g._bl_sweep(_partitioned_edge_w(g, assignment, False), None)


def _partitioned_levels(g: CostGraph, assignment: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    """(tl, bl) where cross-pe edges cost comm(e) and intra-pe edges are free."""
    return (_partitioned_top_levels(g, assignment),
            _partitioned_bottom_levels(g, assignment))


def partitioned_cp_length(g: CostGraph, assignment: np.ndarray) -> float:
    """Length of the critical path of the *partitioned* graph — one
    vectorized bottom-level sweep (the node-switching trial objective)."""
    if g.n == 0:
        return 0.0
    return float(np.max(_partitioned_bottom_levels(g, assignment)))


def _trace_cp(g: CostGraph, assignment: np.ndarray,
              tl: np.ndarray, bl: np.ndarray) -> list[int]:
    """Follow the heaviest w_lvl chain from the CP head."""
    n = g.n
    w = tl + bl
    cp_len = float(np.max(bl))
    heads = [u for u in range(n) if np.isclose(w[u], cp_len) and tl[u] == 0.0]
    if not heads:
        heads = [int(np.argmax(w))]
    cur = heads[0]
    path = [cur]
    while True:
        nxt = -1
        best = -np.inf
        base = tl[cur] + g.comp[cur]
        for v, c in g.out_edges[cur]:
            eff = c if assignment[v] != assignment[cur] else 0.0
            # successor on the CP continues the longest path
            if np.isclose(tl[v], base + eff) and w[v] > best:
                nxt, best = v, w[v]
        if nxt < 0:
            break
        path.append(nxt)
        cur = nxt
    return path


def _switch_can_gain(g: CostGraph, assignment: np.ndarray, node: int,
                     target: int) -> bool:
    """Incremental trial filter: switching ``node`` to ``target`` changes
    only the costs of its incident edges; unless at least one positive-comm
    incident edge becomes intra-pe, every path cost is non-decreasing and
    the partitioned CP cannot shrink — skip the full level recompute."""
    indptr_in, esrc, win = g.csr_in()
    indptr_out, edst, wout = g.csr_out()
    lo, hi = indptr_in[node], indptr_in[node + 1]
    if np.any((assignment[esrc[lo:hi]] == target) & (win[lo:hi] > 0)):
        return True
    lo, hi = indptr_out[node], indptr_out[node + 1]
    return bool(np.any((assignment[edst[lo:hi]] == target)
                       & (wout[lo:hi] > 0)))


def refine_node_switching(g: CostGraph, assignment: np.ndarray, k: int,
                          max_rounds: int | None = None,
                          trials_per_round: int = 16) -> tuple[np.ndarray, dict]:
    """Policy 2. Returns (assignment, stats)."""
    assignment = assignment.copy()
    rounds = max_rounds if max_rounds is not None else k
    switches = 0
    skipped = 0
    cp_before = partitioned_cp_length(g, assignment)
    cp_cur = cp_before
    for _ in range(rounds):
        tl, bl = _partitioned_levels(g, assignment)
        cp = _trace_cp(g, assignment, tl, bl)
        improved = False
        tried = 0
        for i in range(len(cp) - 1):
            u, v = cp[i], cp[i + 1]
            if assignment[u] == assignment[v]:
                continue
            if tried >= trials_per_round:
                break
            tried += 1
            for node, target in ((u, assignment[v]), (v, assignment[u])):
                if not _switch_can_gain(g, assignment, node, target):
                    skipped += 1
                    continue
                old = assignment[node]
                assignment[node] = target
                new_cp = partitioned_cp_length(g, assignment)
                if new_cp < cp_cur - 1e-15:
                    cp_cur = new_cp
                    switches += 1
                    improved = True
                    break
                assignment[node] = old
            if improved:
                break
        if not improved:
            break
    return assignment, {"cp_before": cp_before, "cp_after": cp_cur,
                        "switches": switches, "skipped_trials": skipped}


def refine_cluster_swaps(g: CostGraph, m: Mapping, s_clusters: list[list[int]],
                         k: int, max_candidates: int = 8
                         ) -> tuple[np.ndarray, dict]:
    """Policy 1. Swap secondary clusters with overlapping spans when the swap
    improves (load balance, cut communication) Pareto-wise.

    Incremental evaluation: one O(E) pass precomputes, per secondary
    cluster, its communication volume with the nodes of every device
    (``C[ci, pe]``) and with each adjacent secondary cluster; a swap trial
    is then O(1) arithmetic on those tables instead of four cut sweeps,
    and a committed swap patches only the rows of adjacent clusters.
    """
    assignment = m.assignment.copy()
    comp = np.asarray(g.comp)

    if not m.spans:
        return assignment, {"swaps": 0}

    loads = np.zeros(k)
    np.add.at(loads, assignment, comp)

    ns = len(s_clusters)
    # secondary-cluster id per node (-1 for primaries)
    sec_of = np.full(g.n, -1, dtype=np.int64)
    for ci, cl in enumerate(s_clusters):
        for u in cl:
            sec_of[u] = ci

    # C[ci, pe]: comm between cluster ci and non-ci nodes currently on pe;
    # pair_comm[(ci, cj)]: comm between adjacent secondary clusters.
    _, esrc, edst, ew = g.flat_edges()
    C = np.zeros((ns, k))
    pair_comm: dict[tuple[int, int], float] = {}
    cs, cd = sec_of[esrc], sec_of[edst]
    ext = cs != cd                   # intra-cluster edges never cut
    for a_end, b_end in ((esrc, edst), (edst, esrc)):
        ca = sec_of[a_end]
        sel = ext & (ca >= 0)
        np.add.at(C, (ca[sel], assignment[b_end[sel]]), ew[sel])
    both = ext & (cs >= 0) & (cd >= 0)
    for ci, cj, c in zip(cs[both].tolist(), cd[both].tolist(),
                         ew[both].tolist()):
        key = (ci, cj) if ci < cj else (cj, ci)
        pair_comm[key] = pair_comm.get(key, 0.0) + c
    # adjacency lists among secondaries (for post-swap row patching)
    adj: dict[int, list[int]] = {}
    for (ci, cj) in pair_comm:
        adj.setdefault(ci, []).append(cj)
        adj.setdefault(cj, []).append(ci)
    inc = C.sum(axis=1)              # total external comm per cluster
    cl_w = np.asarray([float(np.sum(comp[cl])) if cl else 0.0
                       for cl in s_clusters])

    def pcomm(ci: int, cj: int) -> float:
        return pair_comm.get((ci, cj) if ci < cj else (cj, ci), 0.0)

    order = sorted(m.spans.keys(), key=lambda ci: m.spans[ci][0])
    starts = np.array([m.spans[ci][0] for ci in order])
    swapped: set[int] = set()
    swaps = 0

    for ci in order:
        if ci in swapped or ci not in m.secondary_pe:
            continue
        cl = s_clusters[ci]
        if not cl:
            continue
        pe_a = int(assignment[cl[0]])
        lo_t, hi_t = m.spans[ci]
        j0 = int(np.searchsorted(starts, lo_t, side="left"))
        j1 = int(np.searchsorted(starts, hi_t, side="right"))
        cands = [order[j] for j in range(j0, min(j1, j0 + max_candidates))]
        for cj in cands:
            if cj == ci or cj in swapped or cj not in m.secondary_pe:
                continue
            cl2 = s_clusters[cj]
            if not cl2:
                continue
            pe_b = int(assignment[cl2[0]])
            if pe_b == pe_a:
                continue
            w1, w2 = cl_w[ci], cl_w[cj]
            old_imb = max(loads[pe_a], loads[pe_b])
            new_a = loads[pe_a] - w1 + w2
            new_b = loads[pe_b] - w2 + w1
            new_imb = max(new_a, new_b)
            # cut(ci on pe) = inc(ci) − comm(ci, nodes on pe); after the
            # swap cj's nodes sit on pe_a, so edges ci↔cj stay cut — the
            # pair term corrects both rows
            x = pcomm(ci, cj)
            old_cut = (inc[ci] - C[ci, pe_a]) + (inc[cj] - C[cj, pe_b])
            new_cut = (inc[ci] - C[ci, pe_b] + x) + \
                      (inc[cj] - C[cj, pe_a] + x)
            better_bal = new_imb < old_imb - 1e-15
            better_cut = new_cut < old_cut - 1e-15
            no_worse = new_imb <= old_imb + 1e-15 and new_cut <= old_cut + 1e-15
            if no_worse and (better_bal or better_cut):
                for u in cl:
                    assignment[u] = pe_b
                for u in cl2:
                    assignment[u] = pe_a
                loads[pe_a] = new_a
                loads[pe_b] = new_b
                # patch comm rows of every adjacent secondary cluster
                for cm in adj.get(ci, ()):
                    x2 = pcomm(cm, ci)
                    C[cm, pe_a] -= x2
                    C[cm, pe_b] += x2
                for cm in adj.get(cj, ()):
                    x2 = pcomm(cm, cj)
                    C[cm, pe_b] -= x2
                    C[cm, pe_a] += x2
                swapped.add(ci)
                swapped.add(cj)
                swaps += 1
                break
    return assignment, {"swaps": swaps}
