"""Cost-annotated computational DAG — the object ParDNN partitions.

The graph mirrors the paper's model (§2, Table 1): each node carries a
computation cost ``comp(n)`` (seconds), a memory consumption ``mem(n)``
(bytes of its output), and a node class (normal / residual / reference);
each edge carries a communication cost ``comm(e)`` (seconds when the edge
crosses devices, zero intra-device).

Stored as flat numpy arrays + adjacency lists so that graphs with hundreds
of thousands of nodes (the paper partitions up to ~190k) stay cheap. On
top of the adjacency lists the graph lazily materialises CSR edge arrays
(``csr_out``/``csr_in``) and a level-bucketed edge ordering so the hot
passes — topological levels, the Step-2 emulator, the memory tracker —
run as batched numpy sweeps instead of per-node Python loops.
"""
from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np


def ranges_index(indptr: np.ndarray, nodes: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Flat CSR indices of ``indptr[u]:indptr[u+1]`` for every u in ``nodes``.

    Returns ``(idx, counts)`` where ``idx`` indexes the CSR value arrays and
    ``counts[i]`` is the number of entries contributed by ``nodes[i]`` —
    the vectorized equivalent of looping ``for u in nodes: adj[u]``.
    """
    cnt = indptr[nodes + 1] - indptr[nodes]
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), cnt
    out_starts = np.cumsum(cnt) - cnt
    idx = (np.arange(total, dtype=np.int64) - np.repeat(out_starts, cnt)
           + np.repeat(indptr[nodes], cnt))
    return idx, cnt


def scatter_max(target: np.ndarray, idx: np.ndarray, vals: np.ndarray) -> None:
    """``target[idx] = max(target[idx], vals)`` with duplicate indices.

    Sort + ``maximum.reduceat`` — considerably faster than ``np.maximum.at``
    for the large scatter batches the vectorized engine produces.
    """
    if idx.size == 0:
        return
    order = np.argsort(idx, kind="stable")
    si = idx[order]
    sv = vals[order]
    change = np.empty(si.size, dtype=bool)
    change[0] = True
    np.not_equal(si[1:], si[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    ui = si[starts]
    m = np.maximum.reduceat(sv, starts)
    target[ui] = np.maximum(target[ui], m)

# Node classes (§3.2.2)
NORMAL = 0    # nor_ns: output memory lives from schedule time to last consumer
RESIDUAL = 1  # res_ns: variables/optimizer state, survive across iterations
REF = 2       # ref_ns: in-place mutators, co-located with their variable


class CostGraph:
    """Directed acyclic cost graph.

    Nodes are dense ints ``0..n-1``. Edges are kept twice (out/in adjacency)
    as parallel lists of ``(neighbor, comm_seconds, bytes)``.
    """

    def __init__(self) -> None:
        self.comp: list[float] = []
        self.mem: list[float] = []
        self.ntype: list[int] = []
        self.names: list[str] = []
        self.out_edges: list[list[tuple[int, float]]] = []
        self.in_edges: list[list[tuple[int, float]]] = []
        # ref_ns -> index of the variable node it mutates (colocation constraint)
        self.colocate_with: dict[int, int] = {}
        # optional per-node *physical* annotations set by the tracer:
        # FLOPs and bytes touched (in+out) — the raw quantities a
        # calibrated device model re-prices comp(n) from without
        # retracing (calibration). None for graphs built by hand.
        self.op_flops: np.ndarray | None = None
        self.op_bytes: np.ndarray | None = None
        # the part of op_flops that is matrix products (mm-class ops and
        # the attention ops' products)
        self.op_dot_flops: np.ndarray | None = None
        self._topo: np.ndarray | None = None
        # lazy vectorization caches (invalidated on mutation)
        self._flat: tuple | None = None      # (indptr, src, dst, w)
        self._csr_in: tuple | None = None    # (indptr_in, src_in, w_in)
        self._levels: tuple | None = None    # (depth, order, level_starts)
        self._tl_pass: tuple | None = None
        self._bl_pass: tuple | None = None

    def _invalidate(self) -> None:
        self._topo = None
        self._flat = None
        self._csr_in = None
        self._levels = None
        self._tl_pass = None
        self._bl_pass = None

    # -- construction -----------------------------------------------------
    def add_node(self, comp: float = 0.0, mem: float = 0.0,
                 ntype: int = NORMAL, name: str = "") -> int:
        nid = len(self.comp)
        self.comp.append(float(comp))
        self.mem.append(float(mem))
        self.ntype.append(int(ntype))
        self.names.append(name or f"n{nid}")
        self.out_edges.append([])
        self.in_edges.append([])
        self._invalidate()
        return nid

    def add_edge(self, src: int, dst: int, comm: float = 0.0) -> None:
        if src == dst:
            raise ValueError(f"self edge on node {src}")
        self.out_edges[src].append((dst, float(comm)))
        self.in_edges[dst].append((src, float(comm)))
        self._invalidate()

    def finalize(self) -> "CostGraph":
        """Convert cost lists to numpy and validate acyclicity."""
        self.comp = np.asarray(self.comp, dtype=np.float64)
        self.mem = np.asarray(self.mem, dtype=np.float64)
        self.ntype = np.asarray(self.ntype, dtype=np.int8)
        self.topo_order()  # raises on cycle
        return self

    # -- basic properties --------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.out_edges)

    @property
    def num_edges(self) -> int:
        if self._flat is not None:
            return int(self._flat[0][-1])
        return sum(len(e) for e in self.out_edges)

    def total_comp(self) -> float:
        return float(np.sum(self.comp))

    def total_comm(self) -> float:
        return sum(c for es in self.out_edges for _, c in es)

    def ccr(self) -> float:
        """Communication-to-computation ratio (§5.3.2)."""
        tc = self.total_comp()
        return self.total_comm() / tc if tc > 0 else 0.0

    # -- flat edge views ----------------------------------------------------
    def flat_edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
        """``(indptr, src, dst, w)`` — out-edges flattened in u-major order.

        Edge ids (positions in these arrays) are stable and match the scan
        order of ``out_edges``; cached until the graph mutates.
        """
        if self._flat is None:
            n = self.n
            cnt = np.fromiter((len(e) for e in self.out_edges),
                              dtype=np.int64, count=n)
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(cnt, out=indptr[1:])
            m = int(indptr[-1])
            src = np.repeat(np.arange(n, dtype=np.int64), cnt)
            dst = np.fromiter((v for es in self.out_edges for v, _ in es),
                              dtype=np.int64, count=m)
            w = np.fromiter((c for es in self.out_edges for _, c in es),
                            dtype=np.float64, count=m)
            self._flat = (indptr, src, dst, w)
        return self._flat

    def csr_out(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Out-adjacency as CSR: ``(indptr, dst, w)``."""
        indptr, _, dst, w = self.flat_edges()
        return indptr, dst, w

    def csr_in(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """In-adjacency as CSR: ``(indptr, src, w)`` (matches ``in_edges``
        order within each node)."""
        if self._csr_in is None:
            n = self.n
            _, src, dst, w = self.flat_edges()
            perm = np.argsort(dst, kind="stable")
            indptr_in = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(np.bincount(dst, minlength=n), out=indptr_in[1:])
            self._csr_in = (indptr_in, src[perm], w[perm])
        return self._csr_in

    def in_degrees(self) -> np.ndarray:
        indptr_in, _, _ = self.csr_in()
        return np.diff(indptr_in)

    # -- orders & levels ----------------------------------------------------
    def _depth_levels(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(depth, order, level_starts)`` via layered Kahn peeling.

        ``depth[u]`` is the longest-path edge count from any source;
        ``order`` lists nodes level-major (ids ascending within a level) —
        a valid topological order; ``level_starts[d]`` is the offset of
        level d in ``order``. Raises on cycle.
        """
        if self._levels is not None:
            return self._levels
        n = self.n
        indptr, _, dst, _ = self.flat_edges()
        indeg = np.bincount(dst, minlength=n)
        depth = np.zeros(n, dtype=np.int64)
        frontier = np.flatnonzero(indeg == 0).astype(np.int64)
        chunks: list[np.ndarray] = []
        starts: list[int] = []
        seen = 0
        d = 0
        while frontier.size:
            depth[frontier] = d
            starts.append(seen)
            chunks.append(frontier)
            seen += frontier.size
            idx, _ = ranges_index(indptr, frontier)
            if idx.size:
                ch = dst[idx]
                indeg -= np.bincount(ch, minlength=n)
                uch = np.unique(ch)
                frontier = uch[indeg[uch] == 0]
            else:
                frontier = np.empty(0, dtype=np.int64)
            d += 1
        if seen != n:
            raise ValueError("cost graph has a cycle")
        order = (np.concatenate(chunks) if chunks
                 else np.empty(0, dtype=np.int64))
        level_starts = np.asarray(starts + [n], dtype=np.int64)
        self._levels = (depth, order, level_starts)
        return self._levels

    def topo_order(self) -> np.ndarray:
        """Topological order (level-major Kahn; cached)."""
        if self._topo is None:
            _, order, _ = self._depth_levels()
            self._topo = order
        return self._topo

    def _edges_by_src_depth(self, group_by_dst: bool) -> tuple:
        """Edges sorted by (depth[src], group-key), with per-level slice
        bounds and per-group reduceat starts — the cached machinery behind
        the vectorized level passes.

        Returns ``(s, t, w, level_bounds, grp_starts, grp_key,
        grp_level_bounds)`` where groups are runs of equal dst (tl pass,
        ``group_by_dst=True``) or equal src (bl pass) within one level.
        """
        cache = self._tl_pass if group_by_dst else self._bl_pass
        if cache is not None:
            return cache
        _, src, dst, w = self.flat_edges()
        depth, _, _ = self._depth_levels()
        nlev = int(depth.max()) + 1 if self.n else 0
        key = dst if group_by_dst else src
        perm = np.lexsort((key, depth[src]))
        s, t, ww = src[perm], dst[perm], w[perm]
        dlev = depth[s]
        klev = key[perm]
        # level slice bounds over the sorted edge array
        level_bounds = np.searchsorted(dlev, np.arange(nlev + 1))
        # group starts: (level, key) change points
        if s.size:
            change = np.r_[True, (klev[1:] != klev[:-1])
                           | (dlev[1:] != dlev[:-1])]
            grp_starts = np.flatnonzero(change)
        else:
            grp_starts = np.empty(0, dtype=np.int64)
        grp_key = klev[grp_starts] if s.size else grp_starts
        grp_level_bounds = np.searchsorted(grp_starts, level_bounds)
        cache = (s, t, ww, level_bounds, grp_starts, grp_key,
                 grp_level_bounds)
        if group_by_dst:
            self._tl_pass = cache
        else:
            self._bl_pass = cache
        return cache

    def _tl_sweep(self, edge_w: np.ndarray | None,
                  active: np.ndarray | None) -> np.ndarray:
        """Forward level sweep computing top levels.

        ``edge_w``: per-edge costs in the cached tl-pass order (None = the
        graph's comm costs) — refinement passes partitioned costs here.
        """
        n = self.n
        comp = np.asarray(self.comp, dtype=np.float64)
        tl = np.zeros(n, dtype=np.float64)
        if n == 0 or self.num_edges == 0:
            return tl
        (s, t, ww, level_bounds, grp_starts, grp_key,
         grp_level_bounds) = self._edges_by_src_depth(group_by_dst=True)
        if edge_w is None:
            edge_w = ww
        for li in range(len(level_bounds) - 1):
            lo, hi = int(level_bounds[li]), int(level_bounds[li + 1])
            if lo == hi:
                continue
            cand = tl[s[lo:hi]] + comp[s[lo:hi]] + edge_w[lo:hi]
            if active is not None:
                cand = np.where(active[s[lo:hi]] & active[t[lo:hi]],
                                cand, -np.inf)
            glo, ghi = int(grp_level_bounds[li]), int(grp_level_bounds[li + 1])
            gs = grp_starts[glo:ghi] - lo
            m = np.maximum.reduceat(cand, gs)
            gd = grp_key[glo:ghi]
            ok = m > -np.inf
            if not ok.all():
                gd, m = gd[ok], m[ok]
            tl[gd] = np.maximum(tl[gd], m)
        return tl

    def _bl_sweep(self, edge_w: np.ndarray | None,
                  active: np.ndarray | None) -> np.ndarray:
        """Reverse level sweep computing bottom levels (see ``_tl_sweep``;
        ``edge_w`` is in the cached bl-pass order)."""
        n = self.n
        comp = np.asarray(self.comp, dtype=np.float64)
        bl = np.zeros(n, dtype=np.float64)
        if n == 0:
            return bl
        depth, order, level_starts = self._depth_levels()
        if self.num_edges == 0:
            if active is None:
                return comp.copy()
            return np.where(active, comp, 0.0)
        (s, t, ww, level_bounds, grp_starts, grp_key,
         grp_level_bounds) = self._edges_by_src_depth(group_by_dst=False)
        if edge_w is None:
            edge_w = ww
        nlev = len(level_starts) - 1
        for li in range(nlev - 1, -1, -1):
            # finalize bl for nodes of this level from their out-edges
            # (children live at strictly deeper levels — already final)
            lo, hi = int(level_bounds[li]), int(level_bounds[li + 1])
            if lo != hi:
                cand = edge_w[lo:hi] + bl[t[lo:hi]]
                if active is not None:
                    cand = np.where(active[s[lo:hi]] & active[t[lo:hi]],
                                    cand, -np.inf)
                glo = int(grp_level_bounds[li])
                ghi = int(grp_level_bounds[li + 1])
                gs = grp_starts[glo:ghi] - lo
                m = np.maximum.reduceat(cand, gs)
                gsrc = grp_key[glo:ghi]
                ok = m > -np.inf
                bl[gsrc[ok]] = m[ok]
            nodes = order[int(level_starts[li]):int(level_starts[li + 1])]
            if active is not None:
                nodes = nodes[active[nodes]]
            bl[nodes] += comp[nodes]
        return bl

    def top_levels(self, active: np.ndarray | None = None) -> np.ndarray:
        """tl(n): costliest path from any source to n, excluding n (Table 1).

        ``active`` restricts to a subgraph (True = node present). Runs as a
        batched sweep over depth levels: within a level all in-edges are
        reduced with ``maximum.reduceat`` in one shot.
        """
        return self._tl_sweep(None, active)

    def bottom_levels(self, active: np.ndarray | None = None) -> np.ndarray:
        """bl(n): costliest path from n to any sink, including n (Table 1)."""
        return self._bl_sweep(None, active)

    def weighted_levels(self, active: np.ndarray | None = None
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """w_lvl(n) = tl(n) + bl(n); returns (w_lvl, tl, bl)."""
        tl = self.top_levels(active)
        bl = self.bottom_levels(active)
        return tl + bl, tl, bl

    def critical_path_length(self) -> float:
        _, _, bl = self.weighted_levels()
        return float(np.max(bl)) if self.n else 0.0

    # -- convenience --------------------------------------------------------
    def fingerprint(self) -> str:
        """Deterministic content hash of the graph's structure and costs.

        Covers node count, comp/mem/ntype arrays, the flat edge list
        (src, dst, comm) and colocation constraints — everything a
        partition depends on. Two traces of the same function produce the
        same fingerprint, so a saved :class:`~repro_torch.api.PartitionPlan`
        can be validated against a fresh trace before reuse.
        """
        h = hashlib.sha256()
        h.update(np.int64(self.n).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(self.comp, dtype=np.float64)).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(self.mem, dtype=np.float64)).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(self.ntype, dtype=np.int8)).tobytes())
        _, src, dst, w = self.flat_edges()
        h.update(src.tobytes())
        h.update(dst.tobytes())
        h.update(np.ascontiguousarray(w).tobytes())
        for k in sorted(self.colocate_with):
            h.update(np.asarray([k, self.colocate_with[k]],
                                dtype=np.int64).tobytes())
        return h.hexdigest()

    def subgraph_active(self, visited: np.ndarray) -> np.ndarray:
        return ~visited

    def edge_bytes(self, comm_to_bytes: float) -> float:
        return self.total_comm() * comm_to_bytes


@dataclass
class Placement:
    """Output of a partitioner: node -> device assignment + quality stats."""
    assignment: np.ndarray                 # int array, node -> pe
    k: int
    makespan: float = float("nan")
    peak_mem: np.ndarray | None = None     # per-pe peak bytes (after emulation)
    feasible: bool = True                  # memory constraints met
    moved_nodes: int = 0                   # Step-2 movements
    stats: dict = field(default_factory=dict)

    def loads(self, g: CostGraph) -> np.ndarray:
        out = np.zeros(self.k)
        np.add.at(out, self.assignment, np.asarray(g.comp))
        return out

    def cut_comm(self, g: CostGraph) -> float:
        a = self.assignment
        return sum(c for u in range(g.n) for v, c in g.out_edges[u]
                   if a[u] != a[v])


def random_dag(n: int, avg_deg: float = 2.5, seed: int = 0,
               comp_scale: float = 1.0, mem_scale: float = 1.0,
               comm_scale: float = 0.5, frac_residual: float = 0.05
               ) -> CostGraph:
    """Random layered DAG generator for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    g = CostGraph()
    for i in range(n):
        ntype = RESIDUAL if rng.random() < frac_residual else NORMAL
        g.add_node(comp=float(rng.exponential(comp_scale)) + 1e-6,
                   mem=float(rng.exponential(mem_scale)) + 1e-6,
                   ntype=ntype)
    n_edges = int(n * avg_deg)
    for _ in range(n_edges):
        u = int(rng.integers(0, n - 1))
        v = int(rng.integers(u + 1, n))
        g.add_edge(u, v, comm=float(rng.exponential(comm_scale)))
    return g.finalize()
