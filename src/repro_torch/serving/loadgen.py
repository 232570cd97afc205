"""Load generation (port of ``repro.serving.loadgen``): seeded Poisson
arrivals, a concurrency-capped open-loop driver, and latency
aggregation.

The generator is deterministic per seed, and draws from numpy in the
reference's order, so one seed gives both packages the same prompts and
arrivals; the driver replays the arrival schedule against an
engine's host clock — a request is submitted once the wall clock passes
its arrival offset — while the engine ticks continuously (continuous
batching means arrivals join mid-flight batches; nothing waits for a
drain).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..obs.stats import percentile

from .scheduler import ServingRequest


@dataclass
class Workload:
    """An arrival schedule: request i arrives ``arrivals_s[i]`` seconds
    after the run starts."""
    requests: list = field(default_factory=list)    # ServingRequest
    arrivals_s: np.ndarray | None = None            # (N,) float64, sorted

    def __len__(self) -> int:
        return len(self.requests)


def poisson_workload(num_requests: int, *, rate_rps: float, vocab: int,
                     prompt_len: tuple[int, int] = (4, 16),
                     max_new_tokens: tuple[int, int] = (4, 16),
                     eos_id: int | None = None,
                     seed: int = 0) -> Workload:
    """Seeded Poisson(rate) arrivals with uniformly-sampled prompt
    lengths and generation budgets. ``prompt_len`` / ``max_new_tokens``
    are inclusive (lo, hi) ranges."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=num_requests)
    arrivals = np.cumsum(gaps)
    arrivals[0] = 0.0               # first request arrives immediately
    reqs = []
    for i in range(num_requests):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        nnew = int(rng.integers(max_new_tokens[0], max_new_tokens[1] + 1))
        prompt = rng.integers(1, vocab, size=plen).astype(np.int32)
        reqs.append(ServingRequest(rid=i, prompt=prompt,
                                   max_new_tokens=nnew, eos_id=eos_id))
    return Workload(requests=reqs, arrivals_s=arrivals)


def run_workload(engine, workload: Workload, *,
                 max_concurrency: int | None = None,
                 max_ticks: int = 100000) -> dict:
    """Drive ``engine`` with ``workload``'s arrival schedule.

    ``max_concurrency`` caps the number of requests in flight (submitted
    but not DONE) — the benchmark's independent variable; arrivals past
    the cap are delayed until a slot opens (their latency clock still
    starts at submit, i.e. queueing shows up in TTFT, as it should).

    Returns ``{"completed": {rid: req}, "wall_s": float}``.
    """
    pending = list(zip(workload.requests, workload.arrivals_s))
    pending.reverse()               # pop() yields earliest-first
    in_flight: set[int] = set()
    t0 = time.perf_counter()
    ticks = 0
    while pending or not engine.scheduler.drained:
        now = time.perf_counter() - t0
        while pending and pending[-1][1] <= now and (
                max_concurrency is None
                or len(in_flight) < max_concurrency):
            req, _ = pending.pop()
            engine.submit(req)
            in_flight.add(req.rid)
        advanced = engine.tick()
        ticks += 1
        if ticks > max_ticks:
            raise RuntimeError(f"workload exceeded max_ticks={max_ticks}")
        in_flight -= set(engine.completed) & in_flight
        if advanced == 0 and pending and engine.scheduler.drained:
            # idle gap before the next arrival — sleep up to it
            wait = pending[-1][1] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.01))
    wall = time.perf_counter() - t0
    engine.scheduler.check_invariants()
    engine.stats.leaked_blocks = engine.allocator.num_in_use
    return {"completed": dict(engine.completed), "wall_s": wall}


def summarize(engine, completed: dict, wall_s: float) -> dict:
    """Latency/throughput summary for one workload run."""
    reqs = list(completed.values())
    ttft = [r.ttft_s() for r in reqs if r.ttft_s() is not None]
    itl = [d for r in reqs for d in r.inter_token_s()]
    tokens = sum(len(r.output) for r in reqs)

    return {
        "requests": len(reqs),
        "generated_tokens": tokens,
        "wall_s": float(wall_s),
        "tokens_per_s": tokens / wall_s if wall_s > 0 else None,
        "ttft_p50_s": percentile(ttft, 50),
        "ttft_p99_s": percentile(ttft, 99),
        "inter_token_p50_s": percentile(itl, 50),
        "inter_token_p99_s": percentile(itl, 99),
        "preempted": engine.stats.preempted,
        "peak_blocks_in_use": engine.allocator.peak_in_use,
        "leaked_blocks": engine.allocator.num_in_use,
    }


__all__ = ["Workload", "poisson_workload", "run_workload", "summarize"]
