"""Percentiles, median/MAD and the latency summary (port of
``repro.obs.stats``): the one copy the serving stats, the load generator
and the measured plan lanes use.

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


def median(xs: Sequence[float]) -> float | None:
    return percentile(xs, 50.0)


def median_mad(samples: Sequence[float]) -> tuple[float, float]:
    """(median, median-absolute-deviation) of ``samples``."""
    s = np.asarray(samples, dtype=np.float64)
    med = float(np.median(s))
    return med, float(np.median(np.abs(s - med)))


def dispersion(samples: Sequence[float]) -> float:
    """MAD / median, the relative-noise score; 0.0 for empty or
    all-zero input."""
    s = [x for x in samples if x is not None]
    if not s:
        return 0.0
    med, mad = median_mad(s)
    return mad / med if med > 0 else 0.0


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


__all__ = ["percentile", "median", "median_mad", "dispersion",
           "latency_summary"]
