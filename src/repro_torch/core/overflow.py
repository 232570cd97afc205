"""Step-2 stage 3: addressing overflow (§3.2.3) — greedy 0-1 min-knapsack.

Given an overflow O on device pe at time t, pick a set of nodes whose
memory potentials at t sum to ≥ O while the total *move cost* (Eqn 4:
node compute weight + communication with same-pe neighbors it would cut)
is minimal. The paper solves this greedily with two heaps:

  * ``ratio_heap``  — all candidates keyed by move_cost / M_pot
    (the movement criteria: cheapest relief per byte first);
  * ``big_heap``    — candidates with M_pot ≥ O keyed by move_cost
    (a single such node can clear the whole overflow).

At each pick, pop the top of both and take the one with the lower
move_cost; the loser is pushed back. The chosen node moves to a device
with enough headroom; a moved node is never moved again (Appendix A).

Candidate scoring is batched: ``move_costs`` computes Eqn (4) for every
candidate in one numpy pass over the flat CSR edge arrays. When an
:class:`~repro_torch.core.memops.IncrementalMemoryTracker` is supplied, each
committed move updates the per-device peaks exactly in O(deg·log V) —
headroom then reflects real profile changes instead of the M_pot
approximation, and a move that would overflow its target is detected and
rolled back before it is committed.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from .graph import CostGraph, REF, RESIDUAL, ranges_index
from .memops import IncrementalMemoryTracker


@dataclass
class OverflowResult:
    moved: list[tuple[int, int, int]]   # (node, from_pe, to_pe)
    resolved: bool
    stats: dict = field(default_factory=dict)


def move_cost(g: CostGraph, assignment: np.ndarray, u: int) -> float:
    """Eqn (4): comp(u) + comm with same-pe direct ancestors/descendants."""
    indptr_in, esrc, win = g.csr_in()
    indptr_out, edst, wout = g.csr_out()
    pu = assignment[u]
    c = float(g.comp[u])
    for i in range(indptr_in[u], indptr_in[u + 1]):
        if assignment[esrc[i]] == pu:
            c += win[i]
    for i in range(indptr_out[u], indptr_out[u + 1]):
        if assignment[edst[i]] == pu:
            c += wout[i]
    return c


def move_costs(g: CostGraph, assignment: np.ndarray,
               nodes: np.ndarray) -> np.ndarray:
    """Batched Eqn (4) over ``nodes`` — one numpy pass, no per-edge Python.

    The per-node accumulation stream is ordered (comp, in-edges, out-edges)
    so the result matches :func:`move_cost`'s fold bit-for-bit.
    """
    nodes = np.asarray(nodes, dtype=np.int64)
    if nodes.size == 0:
        return np.zeros(0)
    comp = np.asarray(g.comp)
    indptr_in, esrc, win = g.csr_in()
    indptr_out, edst, wout = g.csr_out()
    m = nodes.size

    idx_i, cnt_i = ranges_index(indptr_in, nodes)
    seg_i = np.repeat(np.arange(m), cnt_i)
    same_i = assignment[esrc[idx_i]] == assignment[nodes][seg_i]
    idx_o, cnt_o = ranges_index(indptr_out, nodes)
    seg_o = np.repeat(np.arange(m), cnt_o)
    same_o = assignment[edst[idx_o]] == assignment[nodes][seg_o]

    ids = np.concatenate([np.arange(m), seg_i[same_i], seg_o[same_o]])
    vals = np.concatenate([comp[nodes], win[idx_i][same_i],
                           wout[idx_o][same_o]])
    return np.bincount(ids, weights=vals, minlength=m)


def address_overflow(g: CostGraph, assignment: np.ndarray, pe: int,
                     overflow: float, potentials: dict[int, float],
                     headroom: np.ndarray, pinned: set[int],
                     tracker: IncrementalMemoryTracker | None = None,
                     caps: np.ndarray | None = None) -> OverflowResult:
    """One knapsack round for one (pe, t) overflow.

    ``headroom``: spare bytes per pe (cap − predicted peak); updated
    in place as nodes move. ``pinned``: nodes already moved in earlier
    rounds — never reconsidered. With ``tracker`` (and ``caps``), peaks
    and headroom are maintained exactly after every committed move and
    infeasible targets are rolled back.
    """
    ntype = np.asarray(g.ntype)
    cand = np.asarray([u for u, pot in potentials.items()
                       if u not in pinned and pot > 0 and ntype[u] != REF],
                      dtype=np.int64)
    costs = move_costs(g, assignment, cand)
    mc: dict[int, float] = {}
    ratio_heap: list[tuple[float, int]] = []
    big_heap: list[tuple[float, int]] = []
    for u, cost in zip(cand.tolist(), costs.tolist()):
        pot = potentials[u]
        mc[u] = cost
        heapq.heappush(ratio_heap, (cost / pot, u))
        if pot >= overflow:
            heapq.heappush(big_heap, (cost, u))

    moved: list[tuple[int, int, int]] = []
    removed: set[int] = set()
    remaining = overflow
    exact = tracker is not None and caps is not None

    def pop_valid(h):
        while h:
            key, u = heapq.heappop(h)
            if u not in removed:
                return key, u
        return None

    while remaining > 1e-9:
        top_r = pop_valid(ratio_heap)
        top_b = pop_valid(big_heap)
        if top_r is None and top_b is None:
            break
        if top_r is not None and top_b is not None:
            # lower move_cost wins; loser goes back to its heap (§3.2.3)
            if mc[top_r[1]] <= top_b[0]:
                chosen = top_r[1]
                heapq.heappush(big_heap, top_b)
            else:
                chosen = top_b[1]
                heapq.heappush(ratio_heap, top_r)
        else:
            chosen = (top_r or top_b)[1]
        removed.add(chosen)
        pot = potentials[chosen]
        # ref-node colocation: moving a variable drags its mutators along
        group = [chosen] + [r for r, var in g.colocate_with.items()
                            if var == chosen]
        # target: most headroom first
        order = np.argsort(-headroom)
        target = -1
        if exact:
            for c_pe in order:
                c_pe = int(c_pe)
                # cheap M_pot prefilter first; the tracker then verifies
                # the surviving target exactly (and rolls back misfits)
                if c_pe == pe or headroom[c_pe] < pot:
                    continue
                tokens = [tracker.apply_move(nm, c_pe) for nm in group]
                if tracker.peak(c_pe) <= caps[c_pe] + 1e-9:
                    target = c_pe
                    break
                for tok in reversed(tokens):   # would overflow: roll back
                    tracker.revert(tok)
            if target < 0:
                continue  # nobody can host it; try the next node (§3.2.3)
            headroom[:] = caps - tracker.peaks()
            remaining = tracker.peak(pe) - caps[pe]
        else:
            for c_pe in order:
                if c_pe != pe and headroom[c_pe] >= pot:
                    target = int(c_pe)
                    break
            if target < 0:
                continue
            for nmove in group:
                assignment[nmove] = target
            headroom[target] -= pot
            headroom[pe] += pot
            remaining -= pot
        for nmove in group:
            pinned.add(nmove)
        moved.append((chosen, pe, target))

    return OverflowResult(moved=moved, resolved=remaining <= 1e-9,
                          stats={"requested": overflow,
                                 "cleared": overflow - max(remaining, 0.0),
                                 "candidates": len(mc)})
