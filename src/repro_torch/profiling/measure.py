"""Robust micro-timing core (port of ``repro.profiling.measure``): the
estimator every measured number of the profiling package goes through.

One-shot ``perf_counter`` deltas mislead on shared hardware: a host
shared with other jobs puts some samples in a slow mode, so a single
sample is a lottery ticket and a plain mean mixes the modes. The
estimator:

1. **Warmup** calls absorb first-call effects (allocator, cuBLAS
   handles, a kernel library's load).
2. **Median-of-k** with **MAD outlier rejection**: samples further than
   ``outlier_mads`` median-absolute-deviations from the median are
   dropped before estimating.
3. **Load-aware retry**: after rejection the attempt is scored by its
   relative dispersion (MAD / median) and a bimodality gap test (the
   largest inter-sample gap vs the lower cluster's spread). Noisy or
   bimodal attempts are thrown away and re-measured, up to
   ``max_attempts`` times, growing the sample count each retry; the
   attempt with the lowest dispersion wins.
4. **Adaptive cost**: calls longer than ``long_call_s`` amortize noise
   on their own and get ``reps_long`` samples instead of ``reps``.

The clock and the post-call synchronizer are injectable, so the whole
retry/rejection path is testable with a scripted clock (no real
sleeping). On the card, :func:`synchronize` is the synchronizer: a
sample is the host's clock around the call and a wait for the device of
the value it returned, so it measures execution, not the enqueue.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..obs.stats import median_mad


@dataclass(frozen=True)
class MeasureSpec:
    """Knobs of the robust estimator (see the module docstring)."""
    warmup: int = 1                 # unrecorded calls before sampling
    reps: int = 5                   # samples per attempt (short calls)
    reps_long: int = 1              # samples per attempt (long calls)
    long_call_s: float = 1.0        # threshold separating the two
    max_attempts: int = 3           # re-measure rounds on noisy attempts
    dispersion_target: float = 0.15  # accept when MAD/median <= this
    outlier_mads: float = 3.5       # MAD-distance beyond which samples drop
    bimodal_gap: float = 4.0        # gap > this * lower-cluster MAD => bimodal
    grow: float = 2.0               # sample-count multiplier per retry


#: Benchmark-friendly default: one warmup, median-of-5, three attempts.
DEFAULT_SPEC = MeasureSpec()


@dataclass
class Measurement:
    """Result of :func:`measure_call`: a robust estimate plus the
    evidence behind it."""
    seconds: float                  # robust estimate (median of kept)
    mad: float                      # median absolute deviation of kept
    dispersion: float               # mad / seconds (0 when seconds == 0)
    samples: np.ndarray             # the winning attempt's raw samples
    kept: np.ndarray                # samples surviving outlier rejection
    attempts: int = 1               # measurement rounds actually run
    noisy: bool = False             # dispersion target missed everywhere
    bimodal: bool = False           # winning attempt still looked bimodal
    warmup: int = 0
    result: Any = field(default=None, repr=False)  # last fn return value

    @property
    def us(self) -> float:
        return self.seconds * 1e6

    def to_dict(self) -> dict:
        return {"seconds": float(self.seconds), "mad": float(self.mad),
                "dispersion": float(self.dispersion),
                "samples": [float(x) for x in self.samples],
                "kept": int(self.kept.size), "attempts": int(self.attempts),
                "noisy": bool(self.noisy), "bimodal": bool(self.bimodal)}


def synchronize(value: Any) -> Any:
    """Wait until the CUDA devices holding ``value``'s tensors (any
    pytree of them) are idle; nothing for CPU tensors. The ``sync`` of
    every timing on the card: without it a sample measures the enqueue,
    not the work."""
    devices = {t.device for t in pytree.tree_leaves(value)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return value


def reject_outliers(samples: np.ndarray, outlier_mads: float
                    ) -> np.ndarray:
    """Drop samples further than ``outlier_mads`` MADs from the median.

    With MAD == 0 (identical samples, or a degenerate majority) only
    exact-majority values survive a relative guard instead, so a single
    wild outlier among constants is still rejected."""
    s = np.asarray(samples, dtype=np.float64)
    if s.size <= 2:
        return s
    med, mad = median_mad(s)
    if mad > 0.0:
        return s[np.abs(s - med) <= outlier_mads * mad]
    # degenerate spread: fall back to a relative band around the median
    tol = abs(med) * 1e-9 + 1e-12
    kept = s[np.abs(s - med) <= max(tol, abs(med) * 0.5)]
    return kept if kept.size else s


def is_bimodal(samples: np.ndarray, gap_factor: float) -> bool:
    """Largest-gap test: sort the samples and split at the widest gap;
    the attempt is bimodal when both clusters hold >= 2 samples and the
    gap dwarfs the lower cluster's internal spread."""
    s = np.sort(np.asarray(samples, dtype=np.float64))
    if s.size < 4:
        return False
    gaps = np.diff(s)
    i = int(np.argmax(gaps))
    lo, hi = s[:i + 1], s[i + 1:]
    if lo.size < 2 or hi.size < 2:
        return False
    _, lo_mad = median_mad(lo)
    scale = max(lo_mad, abs(float(np.median(lo))) * 0.02, 1e-12)
    return float(gaps[i]) > gap_factor * scale


def _score(samples: np.ndarray, spec: MeasureSpec
           ) -> tuple[np.ndarray, float, float, bool]:
    kept = reject_outliers(samples, spec.outlier_mads)
    med, mad = median_mad(kept)
    disp = mad / med if med > 0 else (0.0 if mad == 0.0 else math.inf)
    return kept, med, disp, is_bimodal(kept, spec.bimodal_gap)


def measure_call(fn: Callable[[], Any], *,
                 spec: MeasureSpec = DEFAULT_SPEC,
                 clock: Callable[[], float] = time.perf_counter,
                 sync: Callable[[Any], Any] | None = None) -> Measurement:
    """Robustly time ``fn()`` (seconds per call).

    Args:
        fn: zero-argument callable; its last return value is kept on the
            measurement (``Measurement.result``) so callers can time and
            use a computation in one pass.
        spec: estimator knobs (:class:`MeasureSpec`).
        clock: monotonic time source (injectable for tests).
        sync: applied to ``fn``'s return value *inside* the timed window
            (:func:`synchronize` on the card); without it, asynchronous
            launches make the sample measure the enqueue, not the work.

    Returns the :class:`Measurement` of the lowest-dispersion attempt.
    """
    result = None

    def sample_once() -> float:
        nonlocal result
        t0 = clock()
        result = fn()
        if sync is not None:
            sync(result)
        return clock() - t0

    for _ in range(max(spec.warmup, 0)):
        sample_once()

    # first probe decides the short/long regime
    first = sample_once()
    reps = spec.reps_long if first >= spec.long_call_s else spec.reps
    reps = max(int(reps), 1)

    best: Measurement | None = None
    attempts = 0
    n = reps
    while attempts < max(spec.max_attempts, 1):
        attempts += 1
        samples = [first] if attempts == 1 else []
        while len(samples) < n:
            samples.append(sample_once())
        samples = np.asarray(samples, dtype=np.float64)
        kept, med, disp, bimodal = _score(samples, spec)
        m = Measurement(seconds=med, mad=med * disp if med > 0 else 0.0,
                        dispersion=disp, samples=samples, kept=kept,
                        attempts=attempts, noisy=False, bimodal=bimodal)
        if best is None or (disp, bimodal) < (best.dispersion, best.bimodal):
            best = m
        if disp <= spec.dispersion_target and not bimodal:
            break
        if med >= spec.long_call_s:
            break    # long calls amortize noise on their own: never grow
            # the sample count on them, even when the first probe landed
            # under the threshold and put us in the short regime
        n = max(int(math.ceil(n * spec.grow)), n + 1)
    assert best is not None
    best.attempts = attempts
    best.noisy = (best.dispersion > spec.dispersion_target
                  or best.bimodal)
    best.warmup = spec.warmup
    best.result = result
    return best


def quick_spec(**overrides) -> MeasureSpec:
    """A cheap spec for smoke tests (no warmup, tiny k); override
    freely: ``quick_spec(reps=2, max_attempts=1)``."""
    base = MeasureSpec(warmup=0, reps=3, max_attempts=2, reps_long=1)
    return replace(base, **overrides)


__all__ = ["DEFAULT_SPEC", "MeasureSpec", "Measurement", "is_bimodal",
           "measure_call", "median_mad", "quick_spec", "reject_outliers",
           "synchronize"]
