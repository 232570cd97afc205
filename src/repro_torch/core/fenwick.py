"""Binary-indexed (Fenwick) tree — per-level load accounting for LALB —
and a max-prefix segment tree for incremental peak-memory tracking.

The paper (§3.1.2) models "work within the span of a secondary cluster"
as frequent range-sum queries with point updates over *levels*, and uses
binary-indexed trees for O(log |V|) per operation. Step-2's incremental
memory tracker needs the harder "maximum prefix sum under point updates"
query (the peak of a ±delta event timeline), which a plain Fenwick tree
cannot answer; :class:`MaxPrefixTree` provides it in O(log n) per update
with an O(1) root read.
"""
from __future__ import annotations

import numpy as np


class Fenwick:
    __slots__ = ("n", "tree")

    def __init__(self, n: int):
        self.n = n
        self.tree = np.zeros(n + 1, dtype=np.float64)

    def add(self, i: int, delta: float) -> None:
        """Point add at index i (0-based)."""
        i += 1
        while i <= self.n:
            self.tree[i] += delta
            i += i & (-i)

    def prefix(self, i: int) -> float:
        """Sum of [0, i] inclusive (0-based); i < 0 -> 0."""
        s = 0.0
        i += 1
        while i > 0:
            s += self.tree[i]
            i -= i & (-i)
        return s

    def range_sum(self, lo: int, hi: int) -> float:
        """Sum of [lo, hi] inclusive."""
        if hi < lo:
            return 0.0
        return self.prefix(hi) - self.prefix(lo - 1)

    def total(self) -> float:
        return self.prefix(self.n - 1)


class MaxPrefixTree:
    """Segment tree over a fixed index range holding, per node, the sum of
    its leaves and the maximum prefix sum within its span.

    ``max_prefix()`` (the root's value) is the peak of the running sum of
    all deltas — exactly the quantity peak-memory tracking needs. Point
    updates are O(log n); ``add_many`` bulk-loads in O(m + touched·log n)
    with vectorized level-by-level pull-ups. Empty leaves carry −inf so
    they never fabricate a prefix of their own.
    """
    __slots__ = ("n", "size", "sum", "maxp")

    def __init__(self, n: int):
        self.n = max(int(n), 1)
        size = 1
        while size < self.n:
            size <<= 1
        self.size = size
        self.sum = np.zeros(2 * size, dtype=np.float64)
        self.maxp = np.full(2 * size, -np.inf, dtype=np.float64)

    def add(self, i: int, delta: float) -> None:
        """Add ``delta`` at leaf i (0-based)."""
        i += self.size
        self.sum[i] += delta
        self.maxp[i] = self.sum[i]
        i >>= 1
        s, m = self.sum, self.maxp
        while i:
            l = 2 * i
            s[i] = s[l] + s[l + 1]
            m[i] = max(m[l], s[l] + m[l + 1])
            i >>= 1

    def add_many(self, idx: np.ndarray, deltas: np.ndarray) -> None:
        """Bulk point-add (duplicate indices accumulate)."""
        idx = np.asarray(idx, dtype=np.int64)
        if idx.size == 0:
            return
        leaf = idx + self.size
        np.add.at(self.sum, leaf, np.asarray(deltas, dtype=np.float64))
        touched = np.unique(leaf)
        self.maxp[touched] = self.sum[touched]
        nodes = np.unique(touched >> 1)
        nodes = nodes[nodes > 0]
        while nodes.size:
            l = nodes << 1
            self.sum[nodes] = self.sum[l] + self.sum[l + 1]
            self.maxp[nodes] = np.maximum(self.maxp[l],
                                          self.sum[l] + self.maxp[l + 1])
            nodes = np.unique(nodes >> 1)
            nodes = nodes[nodes > 0]

    def max_prefix(self) -> float:
        """Maximum over i ≥ 1 of sum(deltas[0:i]); −inf when empty."""
        return float(self.maxp[1])

    def total(self) -> float:
        return float(self.sum[1])


class LevelIndex:
    """Maps continuous tl(n) values to dense level ranks for the BITs."""

    def __init__(self, tl: np.ndarray):
        self.levels = np.unique(tl)
        self.rank = {v: i for i, v in enumerate(self.levels.tolist())}

    @property
    def n(self) -> int:
        return len(self.levels)

    def of(self, t: float) -> int:
        return int(np.searchsorted(self.levels, t))

    def lo_rank(self, t: float) -> int:
        """First level >= t."""
        return int(np.searchsorted(self.levels, t, side="left"))

    def hi_rank(self, t: float) -> int:
        """Last level <= t."""
        return int(np.searchsorted(self.levels, t, side="right")) - 1
