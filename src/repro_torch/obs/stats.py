"""Percentiles and the latency summary (port of the part of
``repro.obs.stats`` that ``ServingStats`` uses).

Percentile ranks are on the 0–100 scale with linear interpolation
(numpy's default); empty inputs yield ``None`` so summaries serialize
before the first token lands.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float | None:
    """Linear-interpolated percentile of ``xs`` (``q`` in 0..100);
    ``None`` on empty input."""
    xs = [x for x in xs if x is not None]
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def median_mad(samples: Sequence[float]) -> tuple[float, float]:
    """(median, median-absolute-deviation) of ``samples``."""
    s = np.asarray(samples, dtype=np.float64)
    med = float(np.median(s))
    return med, float(np.median(np.abs(s - med)))


def latency_summary(xs: Sequence[float], prefix: str = "") -> dict:
    """The standard latency block: p50/p99 plus the robust pair, keyed
    ``{prefix}p50_s``, ``{prefix}p99_s``, ``{prefix}median_s``,
    ``{prefix}mad_s``, ``{prefix}n``."""
    xs = [x for x in xs if x is not None]
    if not xs:
        return {f"{prefix}p50_s": None, f"{prefix}p99_s": None,
                f"{prefix}median_s": None, f"{prefix}mad_s": None,
                f"{prefix}n": 0}
    med, mad = median_mad(xs)
    return {f"{prefix}p50_s": percentile(xs, 50.0),
            f"{prefix}p99_s": percentile(xs, 99.0),
            f"{prefix}median_s": med, f"{prefix}mad_s": mad,
            f"{prefix}n": len(xs)}


__all__ = ["percentile", "median_mad", "latency_summary"]
