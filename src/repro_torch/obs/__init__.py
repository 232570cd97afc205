"""Telemetry (port of ``repro.obs``): spans and counters, Perfetto
traces, the metrics envelope and the shared latency statistics.

Standard library and numpy only, so any module of the port can
instrument itself without import-order concerns.

* :mod:`.spans` — the in-process span/instant/counter API, one
  process-global tracer, off by default (``REPRO_TRACE`` /
  :func:`enable`); the disabled path allocates nothing.
* :mod:`.trace` — Chrome trace-event JSON export: live spans, the
  measured and predicted lanes of a plan execution
  (``plan.execute(trace="out.json")``) and the serving engine's lanes;
  open in ui.perfetto.dev.
* :mod:`.metrics` — the versioned metrics envelope of every
  ``--metrics`` file, with the validator ``python -m repro_torch.obs
  FILE...``.
* :mod:`.stats` — percentiles, median/MAD, the latency summary.
"""
from . import stats
from .metrics import (METRICS_FORMAT, METRICS_SCHEMA_VERSION,
                      MetricsRegistry, MetricsValidationError,
                      read_metrics, validate_doc, wrap_metrics)
from .spans import (Tracer, counter, enable, enabled, get_tracer,
                    instant, span, traced)
from .stats import latency_summary, median_mad, percentile
from .trace import (TraceBuilder, build_plan_trace, export_spans,
                    load_trace, predicted_vs_measured, validate_trace)

__all__ = [
    "stats", "span", "instant", "counter", "enabled", "enable",
    "get_tracer", "Tracer", "traced",
    "TraceBuilder", "export_spans", "build_plan_trace", "load_trace",
    "validate_trace", "predicted_vs_measured",
    "MetricsRegistry", "MetricsValidationError", "wrap_metrics",
    "read_metrics", "validate_doc",
    "METRICS_FORMAT", "METRICS_SCHEMA_VERSION",
    "latency_summary", "median_mad", "percentile",
]
