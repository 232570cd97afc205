"""Structured diagnostics for the static plan verifier.

A :class:`Diagnostic` is one finding: a stable ``RPxxx`` code (the
shared namespace of :mod:`repro_torch.core.errors`), a severity, a message,
and optional provenance (node / segment / device). Passes append
diagnostics to a :class:`DiagnosticReport`; nothing here executes or
imports torch — the whole layer is importable from anywhere in the core.
A copy of the reference's ``repro/analysis/diagnostics.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator

from ..core.errors import CODES

SEVERITIES = ("error", "warn", "info")

ERROR = "error"
WARN = "warn"
INFO = "info"


@dataclass(frozen=True)
class Diagnostic:
    """One finding of a static-analysis pass."""

    code: str                      # stable "RPxxx" code (core.errors.CODES)
    severity: str                  # "error" | "warn" | "info"
    message: str                   # human-readable, self-contained
    pass_name: str = ""            # which pass emitted it
    node: int | None = None        # program/graph node id, when applicable
    segment: int | None = None     # segment sid, when applicable
    device: int | None = None      # pe index, when applicable

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"expected one of {SEVERITIES}")
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}; "
                             f"register it in repro_torch.core.errors.CODES")

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"code": self.code, "severity": self.severity,
                             "message": self.message, "pass": self.pass_name}
        for k in ("node", "segment", "device"):
            v = getattr(self, k)
            if v is not None:
                d[k] = int(v)
        return d

    def __str__(self) -> str:
        where = "".join(
            f" {k}={v}" for k, v in (("seg", self.segment),
                                     ("node", self.node),
                                     ("dev", self.device)) if v is not None)
        return f"[{self.code}] {self.severity}:{where} {self.message}"


@dataclass
class DiagnosticReport:
    """The verifier's result: every finding plus which passes ran.

    ``passes_run`` names the passes that executed (a report with zero
    diagnostics but zero passes proves nothing); ``skipped`` maps pass
    name -> reason for passes that could not run (e.g. no recorded
    program bound).
    """

    diagnostics: list[Diagnostic] = field(default_factory=list)
    passes_run: list[str] = field(default_factory=list)
    skipped: dict[str, str] = field(default_factory=dict)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags: "DiagnosticReport | list[Diagnostic]") -> None:
        if isinstance(diags, DiagnosticReport):
            self.diagnostics.extend(diags.diagnostics)
            self.passes_run.extend(diags.passes_run)
            self.skipped.update(diags.skipped)
        else:
            self.diagnostics.extend(diags)

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def by_severity(self, severity: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self) -> list[Diagnostic]:
        return self.by_severity(ERROR)

    @property
    def warnings(self) -> list[Diagnostic]:
        return self.by_severity(WARN)

    def has_errors(self) -> bool:
        return bool(self.errors)

    def codes(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def counts(self) -> dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for d in self.diagnostics:
            out[d.severity] += 1
        return out

    def summary_dict(self) -> dict[str, Any]:
        """JSON-serializable summary for plan headers / conformance
        records: severity counts, per-code counts, the passes that ran,
        and the full error/warn findings (info findings are counted but
        not expanded — they can be bulky on large graphs)."""
        per_code: dict[str, int] = {}
        for d in self.diagnostics:
            per_code[d.code] = per_code.get(d.code, 0) + 1
        return {
            "counts": self.counts(),
            "by_code": dict(sorted(per_code.items())),
            "passes_run": list(self.passes_run),
            "skipped": dict(self.skipped),
            "findings": [d.to_dict() for d in self.diagnostics
                         if d.severity != INFO],
        }

    def to_dict(self) -> dict[str, Any]:
        return {"diagnostics": [d.to_dict() for d in self.diagnostics],
                "passes_run": list(self.passes_run),
                "skipped": dict(self.skipped)}

    def render(self, *, max_findings: int = 50) -> str:
        """Human-readable multi-line summary (the CLI's output body)."""
        c = self.counts()
        lines = [f"{c['error']} error(s), {c['warn']} warning(s), "
                 f"{c['info']} info — passes: "
                 f"{', '.join(self.passes_run) or 'none'}"]
        for name, why in self.skipped.items():
            lines.append(f"  skipped {name}: {why}")
        shown = 0
        for sev in SEVERITIES:
            for d in self.by_severity(sev):
                if shown >= max_findings:
                    lines.append(f"  ... {len(self.diagnostics) - shown} "
                                 f"more finding(s) suppressed")
                    return "\n".join(lines)
                lines.append(f"  {d}")
                shown += 1
        return "\n".join(lines)
