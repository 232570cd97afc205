"""Telemetry: spans/counters and the shared latency statistics."""
from .spans import counter, enable, enabled, get_tracer, instant, span
from .stats import latency_summary, median_mad, percentile

__all__ = ["counter", "enable", "enabled", "get_tracer", "instant", "span",
           "latency_summary", "median_mad", "percentile"]
