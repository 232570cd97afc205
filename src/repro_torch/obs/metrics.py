"""MetricsRegistry — one versioned envelope for every emitted metric
(port of ``repro.obs.metrics``: the same format name and schema version,
so a file written by either package reads in the other).

Every JSON artifact the port emits (``--metrics`` dumps from the
launchers, serving summaries) wraps its payload in the same envelope::

    {"format": "repro-metrics", "schema_version": 1,
     "source": "bench_overhead.runtime",
     "meta": {...free-form context...},
     "metrics": {...the payload...}}

mirroring the plan artifact's ``PLAN_FORMAT``/``PLAN_SCHEMA_VERSION``
contract: loading rejects unknown schema versions, and
``python -m repro_torch.obs FILE...`` shape-checks emitted files
(:func:`validate_doc`). Validation is **shape only** — key presence,
version, JSON-serializable values, finite floats; wall-clock numbers
are recorded for humans and never gated.

:func:`read_metrics` unwraps both enveloped and legacy bare-dict files.
"""
from __future__ import annotations

import json
import math
import sys
from typing import Any

METRICS_FORMAT = "repro-metrics"
METRICS_SCHEMA_VERSION = 1
KNOWN_METRICS_VERSIONS = (1,)


class MetricsValidationError(ValueError):
    """A metrics document failed envelope/schema validation."""


class MetricsRegistry:
    """Accumulates a metrics payload and emits the versioned envelope.

    >>> reg = MetricsRegistry("launch_serve", meta={"arch": a})
    >>> reg.record("speedup", 42.0)
    >>> reg.group("levels", [...])
    >>> reg.save("serve.metrics.json")
    """

    def __init__(self, source: str, meta: dict | None = None) -> None:
        self.source = str(source)
        self.meta = dict(meta or {})
        self.metrics: dict[str, Any] = {}

    def record(self, name: str, value: Any) -> None:
        self.metrics[str(name)] = value

    def group(self, name: str, payload: Any) -> None:
        """Attach a structured sub-document (list/dict) under ``name``."""
        self.metrics[str(name)] = payload

    def update(self, payload: dict) -> None:
        self.metrics.update(payload)

    def to_dict(self) -> dict:
        return {"format": METRICS_FORMAT,
                "schema_version": METRICS_SCHEMA_VERSION,
                "source": self.source, "meta": self.meta,
                "metrics": self.metrics}

    def save(self, path: str) -> str:
        doc = self.to_dict()
        problems = validate_doc(doc)
        if problems:
            raise MetricsValidationError(
                f"refusing to save invalid metrics ({path}):\n  "
                + "\n  ".join(problems))
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return path

    @classmethod
    def load(cls, path: str) -> "MetricsRegistry":
        with open(path) as f:
            doc = json.load(f)
        problems = validate_doc(doc)
        if problems:
            raise MetricsValidationError(
                f"{path}: invalid metrics document:\n  "
                + "\n  ".join(problems))
        reg = cls(doc["source"], meta=doc.get("meta"))
        reg.metrics = dict(doc["metrics"])
        return reg


def wrap_metrics(source: str, payload: dict,
                 meta: dict | None = None) -> dict:
    """One-shot envelope for existing payload dicts."""
    reg = MetricsRegistry(source, meta=meta)
    reg.update(payload)
    return reg.to_dict()


def read_metrics(path_or_doc) -> dict:
    """The payload of a metrics file, enveloped or legacy. Enveloped
    documents are validated (unknown versions raise); a bare dict is
    returned as-is."""
    if isinstance(path_or_doc, str):
        with open(path_or_doc) as f:
            doc = json.load(f)
    else:
        doc = path_or_doc
    if isinstance(doc, dict) and doc.get("format") == METRICS_FORMAT:
        problems = validate_doc(doc)
        if problems:
            raise MetricsValidationError("\n".join(problems))
        return doc["metrics"]
    return doc


def _check_values(x: Any, where: str, problems: list[str]) -> None:
    if isinstance(x, dict):
        for k, v in x.items():
            if not isinstance(k, str):
                problems.append(f"{where}: non-string key {k!r}")
            else:
                _check_values(v, f"{where}.{k}", problems)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _check_values(v, f"{where}[{i}]", problems)
    elif isinstance(x, bool) or x is None or isinstance(x, (int, str)):
        pass
    elif isinstance(x, float):
        if not math.isfinite(x):
            problems.append(f"{where}: non-finite float {x!r}")
    else:
        problems.append(f"{where}: non-JSON value of type "
                        f"{type(x).__name__}")


def validate_doc(doc: Any) -> list[str]:
    """Shape-check a metrics document; returns problems (empty = valid)."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["metrics document is not an object"]
    if doc.get("format") != METRICS_FORMAT:
        problems.append(f"format is {doc.get('format')!r}, "
                        f"expected {METRICS_FORMAT!r}")
    ver = doc.get("schema_version")
    if ver not in KNOWN_METRICS_VERSIONS:
        problems.append(f"unknown schema_version {ver!r}; this build "
                        f"supports {list(KNOWN_METRICS_VERSIONS)}")
    if not isinstance(doc.get("source"), str) or not doc.get("source"):
        problems.append("source missing or not a non-empty string")
    if "meta" in doc and not isinstance(doc["meta"], dict):
        problems.append("meta is not an object")
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        problems.append("metrics missing or not an object")
    else:
        _check_values(metrics, "metrics", problems)
    return problems


def validate_file(path: str) -> list[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable: {e}"]
    return validate_doc(doc)


def main(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.obs FILE...`` — the schema gate.
    Exit 0 when every file validates, 1 when one does not (per-file
    problems printed), 2 without a file."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs FILE...")
        return 2
    bad = 0
    for path in argv:
        problems = validate_file(path)
        if problems:
            bad += 1
            print(f"INVALID {path}")
            for p in problems:
                print(f"  {p}")
        else:
            print(f"ok      {path}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["MetricsRegistry", "MetricsValidationError", "wrap_metrics",
           "read_metrics", "validate_doc", "validate_file",
           "METRICS_FORMAT", "METRICS_SCHEMA_VERSION"]
