"""Baselines the paper compares against (§5.4.2-§5.4.3, Fig 5).

* ``round_robin`` — topological-order round robin over K devices (Fig 5a).
* ``linear_clustering`` — Kim-Browne LC: peel critical paths with a level
  *recompute after every peel* (O(|V|(|V|+|E|)) — the expensive classic
  ParDNN's slicing short-circuits), then GLB cluster merging (Fig 5b,
  the paper's "LC + GLB + EST-first" comparison).
* ``glb_partition`` — ParDNN slicing + GLB (non-temporal, comm-blind)
  mapping: isolates LALB's contribution (Fig 2(d) vs (e)).
* ``topo_contiguous`` — contiguous topological chunks balanced by compute
  (the "uniform pipeline split" every PP system defaults to).
"""
from __future__ import annotations

import numpy as np

from .graph import CostGraph, Placement
from .emulator import emulate
from .mapping import glb_map
from .memops import compute_profile
from .partitioner import PardnnOptions, pardnn_partition
from .slicing import Slicing, _heaviest_path


def _finish(g: CostGraph, assignment: np.ndarray, k: int) -> Placement:
    sched = emulate(g, assignment, k)
    prof = compute_profile(g, assignment, sched, k)
    return Placement(assignment=assignment, k=k, makespan=sched.makespan,
                     peak_mem=prof.peak)


def round_robin(g: CostGraph, k: int) -> Placement:
    order = g.topo_order()
    assignment = np.zeros(g.n, dtype=np.int64)
    assignment[order] = np.arange(g.n) % k
    return _finish(g, assignment, k)


def topo_contiguous(g: CostGraph, k: int) -> Placement:
    """Split topo order into K contiguous chunks with ~equal compute."""
    order = g.topo_order()
    comp = np.asarray(g.comp)[order]
    cum = np.cumsum(comp)
    total = cum[-1] if len(cum) else 0.0
    assignment = np.zeros(g.n, dtype=np.int64)
    bounds = [total * (i + 1) / k for i in range(k)]
    pe = 0
    for i, u in enumerate(order):
        while pe < k - 1 and cum[i] > bounds[pe]:
            pe += 1
        assignment[u] = pe
    return _finish(g, assignment, k)


def linear_clustering(g: CostGraph, k: int,
                      max_recomputes: int | None = None) -> Placement:
    """Classic linear clustering: recompute weighted levels after *every*
    path peel (not just the first K), then GLB-merge clusters onto K pes.

    ``max_recomputes`` caps the expensive recomputations for very large
    graphs (the paper reports 4.5 h for WRN/190k nodes — we cap in
    benchmarks but default to the faithful unbounded behaviour)."""
    n = g.n
    visited = np.zeros(n, dtype=bool)
    clusters: list[list[int]] = []
    w_full, tl_full, bl_full = g.weighted_levels()
    w_lvl = w_full
    recomputes = 0
    while not visited.all():
        path = _heaviest_path(g, w_lvl, visited)
        if not path:
            break
        clusters.append(path)
        if visited.all():
            break
        if max_recomputes is None or recomputes < max_recomputes:
            active = ~visited
            w_lvl, _, _ = g.weighted_levels(active)
            w_lvl = np.where(active, w_lvl, -np.inf)
            recomputes += 1

    # GLB merge of the linear clusters onto k devices
    s = Slicing(primaries=[[] for _ in range(k)], secondaries=clusters,
                tl=tl_full, bl=bl_full)
    m = glb_map(g, s)
    return _finish(g, m.assignment, k)


def glb_partition(g: CostGraph, k: int) -> Placement:
    """ParDNN slicing + GLB mapping (LALB ablation)."""
    opts = PardnnOptions(lalb=False, refine=False)
    return pardnn_partition(g, k, mem_caps=None, options=opts)


def pardnn_no_refinement(g: CostGraph, k: int,
                         mem_caps=None) -> Placement:
    opts = PardnnOptions(refine=False)
    return pardnn_partition(g, k, mem_caps=mem_caps, options=opts)


BASELINES = {
    "rr": round_robin,
    "topo": topo_contiguous,
    "lc": linear_clustering,
    "glb": glb_partition,
    "pardnn_norefine": pardnn_no_refinement,
}
