"""ParDNN partitioner — orchestrates Step-1 (slicing → mapping → refinement)
and Step-2 (emulate → track memory → knapsack overflow moves).

``pardnn_partition`` is the paper's end-to-end algorithm; it is purely
ahead-of-time (no runtime component) and returns a ``Placement``.

The Step-2 inner loop runs on the vectorized engine by default (batched
frontier emulation + numpy memory profile, see ``emulator.py`` /
``memops.py``) with an :class:`~repro_torch.core.memops.IncrementalMemoryTracker`
maintaining exact per-device peaks across knapsack moves; set
``PardnnOptions(engine="scalar")`` or ``REPRO_STEP2_ENGINE=scalar`` to run
the legacy reference implementations instead (both engines produce
identical schedules and profiles).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..obs.spans import span as _span
from .emulator import emulate
from .graph import CostGraph, Placement
from .mapping import map_clusters, glb_map
from .memops import (IncrementalMemoryTracker, compute_profile,
                     memory_potentials)
from .overflow import address_overflow
from .refinement import refine_cluster_swaps, refine_node_switching
from .slicing import slice_graph


@dataclass
class PardnnOptions:
    """Tuning knobs for :func:`pardnn_partition`.

    Attributes:
        refine: Run Stage-III refinement (cluster swaps + node switching).
            Disabling reproduces the paper's Fig 5a ablation.
        lalb: Use Level-Aware Load Balancing for the mapping stage; when
            False, fall back to Guided Load Balancing (the GLB baseline).
        max_memory_rounds: Outer Step-2 iterations; each round re-emulates
            the schedule, rebuilds the memory profile, and runs one
            knapsack pass per overflowing device.
        node_switch_trials: CP-edge switch trials per refinement round
            (Policy 2); capped automatically for graphs above 20k nodes.
        comm_scale: Multiplier on all cross-device communication costs
            (CCR sweeps, §5.3.2).
        memory_fraction: Fraction of each device's capacity the partition
            may plan to (paper §4 uses 90% to leave runtime slack).
        engine: Step-2 engine — "vector" (batched numpy, default),
            "scalar" (legacy reference loops), or None to inherit the
            ``REPRO_STEP2_ENGINE`` environment default.
        use_tracker: Maintain exact per-device peaks incrementally during
            knapsack moves (O(deg·log V) per move) instead of the M_pot
            headroom approximation.
    """
    refine: bool = True                 # Stage-III on/off (Fig 5a ablation)
    lalb: bool = True                   # False -> GLB mapping (baseline)
    max_memory_rounds: int = 8          # outer Step-2 iterations
    node_switch_trials: int = 16
    comm_scale: float = 1.0
    memory_fraction: float = 0.9        # paper §4: use 90% of device memory
    engine: str | None = None           # Step-2 engine ("vector"/"scalar")
    use_tracker: bool = True            # incremental peak tracking in Step-2


def pardnn_partition(g: CostGraph, k: int,
                     mem_caps: np.ndarray | float | None = None,
                     options: PardnnOptions | None = None,
                     progress: Callable[[str, dict], None] | None = None
                     ) -> Placement:
    """Partition cost graph ``g`` across ``k`` devices (the full ParDNN
    algorithm, Algorithms 1-2 + Step-2).

    Args:
        g: Finalized :class:`~repro_torch.core.graph.CostGraph` — comp seconds,
            mem bytes, and node classes per node, comm seconds per edge.
        k: Number of (homogeneous) devices.
        mem_caps: Per-device memory capacity in bytes — a scalar applied
            to every device, an array of length ``k``, or None to skip
            Step-2's overflow handling entirely.
        options: :class:`PardnnOptions`; defaults are the paper's setup.
        progress: Optional ``progress(stage, info)`` callback invoked at
            every stage boundary (``"slice"``, ``"map"``, ``"refine"``,
            one ``"step2_round"`` per memory round, ``"done"``) with a
            dict of counters for that stage — lets long partitions (100k+
            node graphs) report liveness to callers such as
            :func:`repro_torch.api.partition`.

    Returns:
        :class:`~repro_torch.core.graph.Placement` with the node→device
        assignment, the emulated makespan, per-device peak memory,
        ``feasible`` (memory caps met), and a ``stats`` dict of per-stage
        wall times, mapping/refinement counters, and Step-2 movement
        totals.
    """
    opt = options or PardnnOptions()
    eng = opt.engine
    notify = progress if progress is not None else (lambda stage, info: None)
    total_span = _span("partition/total", n=g.n, k=k).__enter__()
    t0 = time.perf_counter()

    # ---------------- Step-1 ----------------
    with _span("partition/slice", n=g.n, k=k):
        s = slice_graph(g, k)
    t_slice = time.perf_counter()
    notify("slice", {"num_secondaries": len(s.secondaries),
                     "seconds": t_slice - t0})

    with _span("partition/map", lalb=opt.lalb):
        m = map_clusters(g, s) if opt.lalb else glb_map(g, s)
    t_map = time.perf_counter()
    notify("map", {**m.stats, "seconds": t_map - t_slice})

    assignment = m.assignment
    ref_stats: dict = {}
    if opt.refine:
        refine_span = _span("partition/refine").__enter__()
        refined, swap_stats = refine_cluster_swaps(
            g, m, s.secondaries, k)
        # size-aware caps: each switch round recomputes levels (O(V+E));
        # at paper scale (≥100k nodes) cap rounds/trials to stay within
        # the paper's seconds-to-2-minutes overhead envelope (§5.4.1)
        big = g.n > 20_000
        refined, switch_stats = refine_node_switching(
            g, refined, k,
            max_rounds=(2 if big else None),
            trials_per_round=(4 if big else opt.node_switch_trials))
        ref_stats = {**swap_stats, **switch_stats}
        # the refinement objective is the partitioned-CP length (paper
        # §3.1.3); guard with the emulator so it never hurts end-to-end
        base_mk = emulate(g, assignment, k, comm_scale=opt.comm_scale,
                          engine=eng)
        ref_mk = emulate(g, refined, k, comm_scale=opt.comm_scale,
                         engine=eng)
        if ref_mk.makespan <= base_mk.makespan:
            assignment = refined
        else:
            ref_stats["reverted"] = True
        refine_span.__exit__(None, None, None)
    t_refine = time.perf_counter()
    if opt.refine:
        notify("refine", {**ref_stats, "seconds": t_refine - t_map})

    # ---------------- Step-2 ----------------
    moved_total = 0
    step2_rounds = 0
    feasible = True
    pinned: set[int] = set()
    caps = None
    if mem_caps is not None:
        caps = (np.full(k, float(mem_caps)) if np.isscalar(mem_caps)
                else np.asarray(mem_caps, dtype=np.float64))
        caps = caps * opt.memory_fraction
        for _ in range(opt.max_memory_rounds):
            round_span = _span("partition/step2_round",
                               round=step2_rounds + 1).__enter__()
            sched = emulate(g, assignment, k, comm_scale=opt.comm_scale,
                            engine=eng)
            prof = compute_profile(g, assignment, sched, k, engine=eng)
            overflows = prof.first_overflow(caps)
            if not overflows:
                feasible = True
                round_span.__exit__(None, None, None)
                break
            feasible = False
            step2_rounds += 1
            tracker = (IncrementalMemoryTracker(g, assignment, sched, k)
                       if opt.use_tracker else None)
            headroom = caps - (tracker.peaks() if tracker is not None
                               else prof.peak)
            progressed = False
            for pe, t_over, amount in overflows:
                if tracker is not None:
                    # earlier moves this round may have already relieved pe
                    amount = tracker.peak(pe) - caps[pe]
                    if amount <= 1e-9:
                        continue
                pots = memory_potentials(g, assignment, sched, prof, pe,
                                         t_over, engine=eng)
                res = address_overflow(g, assignment, pe, amount, pots,
                                       headroom, pinned, tracker=tracker,
                                       caps=caps if tracker is not None
                                       else None)
                moved_total += len(res.moved)
                if res.moved:
                    progressed = True
            notify("step2_round", {"round": step2_rounds,
                                   "overflowing_pes": len(overflows),
                                   "moved_total": moved_total})
            round_span.__exit__(None, None, None)
            if not progressed:
                break  # ran out of movable nodes (§3.2.3 termination)
        else:
            sched = emulate(g, assignment, k, comm_scale=opt.comm_scale,
                            engine=eng)
            prof = compute_profile(g, assignment, sched, k, engine=eng)
            feasible = not prof.first_overflow(caps)

    sched = emulate(g, assignment, k, comm_scale=opt.comm_scale, engine=eng)
    prof = compute_profile(g, assignment, sched, k, engine=eng)
    if caps is not None:
        feasible = not prof.first_overflow(caps)
    t_end = time.perf_counter()

    notify("done", {"makespan": sched.makespan, "feasible": feasible,
                    "moved": moved_total, "seconds": t_end - t0})
    total_span.__exit__(None, None, None)
    return Placement(
        assignment=assignment, k=k, makespan=sched.makespan,
        peak_mem=prof.peak, feasible=feasible, moved_nodes=moved_total,
        stats={
            "slice_s": t_slice - t0,
            "map_s": t_map - t_slice,
            "refine_s": t_refine - t_map,
            "step2_s": t_end - t_refine,
            "total_s": t_end - t0,
            "num_secondaries": len(s.secondaries),
            "mapping": m.stats,
            "refinement": ref_stats,
            "step2_rounds": step2_rounds,
            "moved_frac": moved_total / max(g.n, 1),
        })
