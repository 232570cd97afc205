"""Stage-I graph slicing (paper Algorithm 1).

Iteratively peel the heaviest path off the graph. The first K peels —
with weighted levels recomputed after every peel — are the *primary
clusters*, one per processing element. Every later peel reuses the stale
levels (the paper's complexity-reduction trick) and yields a *secondary
cluster*: a path, or a single node when no path can be extended.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .graph import CostGraph


@dataclass
class Slicing:
    primaries: list[list[int]]      # K clusters (node id lists, path order)
    secondaries: list[list[int]]    # S clusters (paths or singletons)
    tl: np.ndarray                  # top levels of the *original* graph
    bl: np.ndarray
    stats: dict = field(default_factory=dict)

    @property
    def k(self) -> int:
        return len(self.primaries)


def _heaviest_path(g: CostGraph, w_lvl: np.ndarray, visited: np.ndarray,
                   order_hint: np.ndarray | None = None,
                   start: int | None = None) -> list[int]:
    """Traverse by w_lvl priority from the heaviest unvisited node.

    Extends forward (toward heaviest unvisited successor) and backward
    (toward heaviest unvisited predecessor) "until reaching a dead-end"
    (§3.1.1). Returns nodes in topological (path) order.
    """
    if start is None:
        cand = np.where(~visited)[0]
        if cand.size == 0:
            return []
        start = int(cand[np.argmax(w_lvl[cand])])
    path = [start]
    visited[start] = True
    # forward extension
    cur = start
    while True:
        nxt, best = -1, -np.inf
        for v, _ in g.out_edges[cur]:
            if not visited[v] and w_lvl[v] > best:
                nxt, best = v, w_lvl[v]
        if nxt < 0:
            break
        path.append(nxt)
        visited[nxt] = True
        cur = nxt
    # backward extension
    cur = start
    while True:
        prv, best = -1, -np.inf
        for u, _ in g.in_edges[cur]:
            if not visited[u] and w_lvl[u] > best:
                prv, best = u, w_lvl[u]
        if prv < 0:
            break
        path.insert(0, prv)
        visited[prv] = True
        cur = prv
    return path


def slice_graph(g: CostGraph, k: int) -> Slicing:
    """Algorithm 1: K primary clusters (CPs with level recompute) then
    secondary clusters with stale levels."""
    n = g.n
    visited = np.zeros(n, dtype=bool)
    primaries: list[list[int]] = []
    secondaries: list[list[int]] = []

    # levels on the full graph — kept for the mapping stage (span/potential)
    w_full, tl_full, bl_full = g.weighted_levels()

    w_lvl = w_full
    for j in range(min(k, n)):
        path = _heaviest_path(g, w_lvl, visited)
        if not path:
            break
        primaries.append(path)
        if j + 1 < k and not visited.all():
            # recompute weighted levels on the remaining subgraph (Line 7)
            active = ~visited
            w_lvl, _, _ = g.weighted_levels(active)
            w_lvl = np.where(active, w_lvl, -np.inf)

    # make sure we always return exactly k primaries (pad with empties:
    # graphs smaller than k devices)
    while len(primaries) < k:
        primaries.append([])

    # secondary clusters: stale levels, no recompute (Lines 9-10)
    if not visited.all():
        # stale priority = last recomputed w_lvl; iterate seeds in that order
        remaining = np.where(~visited)[0]
        seed_order = remaining[np.argsort(-w_lvl[remaining], kind="stable")]
        for s in seed_order:
            if visited[s]:
                continue
            path = _heaviest_path(g, w_lvl, visited, start=int(s))
            if path:
                secondaries.append(path)

    assert visited.all()
    return Slicing(primaries=primaries, secondaries=secondaries,
                   tl=tl_full, bl=bl_full,
                   stats={"n": n, "k": k, "num_secondaries": len(secondaries)})
