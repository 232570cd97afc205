"""Static plan verification: prove schedule safety without executing.

A copy of the reference's ``repro/analysis`` (its ``__init__``,
``diagnostics`` and ``passes``; numpy only). The passes read the
program's structure, the placement and the segment schedule, so both
packages give the same diagnostics on the same plan:

    from repro_torch import api
    traced = api.trace(step, params, record=True)
    plan = api.partition(traced, devices=4, memory=2e9)
    report = plan.verify()          # DiagnosticReport, no execution
    assert not report.has_errors()

Entry points:

* :func:`analyze` — run the passes over a program + placement (+
  optional pre-built schedule, for a mutation harness);
* :func:`analyze_plan` — the same over a
  :class:`~repro_torch.api.PartitionPlan`, adding artifact-level checks
  (schema, fingerprint).

Beside them, as in the reference: the command line
(``python -m repro_torch.analysis PLAN [--arch A]``), the mutation
harness (:mod:`.mutate`) and the random-program generator
(:mod:`.synth`). The code registry is
:data:`repro_torch.core.errors.CODES`.

The memory certificate replays the reference's schedule, donation
included, and the port's runtime donates as the reference's does
(``CompiledRuntime.donated``: ``Segment.dead_inputs``, masked for PEs
folded onto one device as the reference masks them), so RP003 and RP042
guard what it runs. Two differences remain. A read from another device
is a copy into a buffer of the runtime's, never donated: with PEs on
different devices a transferred copy may outlive the certificate's.
With PEs folded onto one device the runtime makes no copy, and the
certificate, which charges one per cross-PE read, bounds its logical
peaks from above.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..core import errors as E
from ..core.errors import CODES, PlanValidationError
from ..core.segments import cut_segments
from .diagnostics import (ERROR, INFO, SEVERITIES, WARN, Diagnostic,
                          DiagnosticReport)
from .passes import (PASSES, AnalysisContext, InterpResult,
                     OverlapInterpResult, abstract_interpret,
                     overlap_interpret)

__all__ = [
    "analyze", "analyze_plan", "Diagnostic", "DiagnosticReport",
    "AnalysisContext", "InterpResult", "OverlapInterpResult",
    "abstract_interpret", "overlap_interpret", "PASSES",
    "CODES", "SEVERITIES", "ERROR", "WARN", "INFO",
]

#: passes that need an interpretable schedule (run after placement+lint)
_SCHEDULE_PASSES = ("structure", "deadlock", "liveness", "memory",
                    "overlap")


def analyze(prog=None, assignment=None, k: int = 1, *, schedule=None,
            graph=None, mem_caps=None, feasible=None,
            predicted_peaks=None,
            transfer_window_bytes=None) -> DiagnosticReport:
    """Run every applicable pass; never raises on a corrupt schedule.

    Args:
        prog: the recorded :class:`~repro_torch.core.executor.TracedProgram`
            (None: only the placement pass can run).
        assignment: node -> pe placement (None: single device 0).
        k: device count the placement must fit in.
        schedule: a pre-built (possibly corrupted) ``SegmentSchedule``;
            when None the schedule is cut fresh from the program — the
            normal verification path.
        graph: the :class:`~repro_torch.core.graph.CostGraph` (enables the
            memory certificate via its per-node byte annotations).
        mem_caps: per-device capacity in bytes (scalar or length-k).
        feasible: the plan's feasibility claim — a certificate above
            ``mem_caps`` is an *error* only for plans claiming to fit.
        predicted_peaks: Step-2's per-device peak prediction, for the
            RP021 cross-check.
        transfer_window_bytes: the in-flight transfer window the overlap
            pass certifies RP040 against (None: the runtime's own
            resolution — ``REPRO_TRANSFER_WINDOW_MB`` or 64 MiB).
    """
    rep = DiagnosticReport()
    a = None if assignment is None else np.asarray(assignment)
    ctx = AnalysisContext(prog=prog, assignment=a, k=int(k),
                          schedule=schedule, graph=graph, mem_caps=mem_caps,
                          feasible=feasible, predicted_peaks=predicted_peaks,
                          transfer_window_bytes=transfer_window_bytes)
    PASSES["placement"](ctx, rep)
    rep.passes_run.append("placement")
    if prog is None:
        for name in _SCHEDULE_PASSES + ("lint",):
            rep.skipped[name] = ("no recorded program bound — trace with "
                                 "record=True for full verification")
        return rep
    PASSES["lint"](ctx, rep)
    rep.passes_run.append("lint")
    if any(d.code == E.RP032_PLACEMENT_HOLE for d in rep.errors):
        for name in _SCHEDULE_PASSES:
            rep.skipped[name] = ("placement invalid (RP032) — the schedule "
                                 "cannot be interpreted")
        return rep
    if ctx.schedule is None:
        try:
            ctx.schedule = cut_segments(prog, a, k=ctx.k)
        except PlanValidationError as e:
            rep.add(Diagnostic(code=e.code, severity=ERROR,
                               message=str(e), pass_name="cut"))
            for name in _SCHEDULE_PASSES:
                rep.skipped[name] = "cut_segments failed"
            return rep
    for name in _SCHEDULE_PASSES:
        if name == "memory" and (
                graph is None or len(getattr(graph, "mem", [])) == 0):
            rep.skipped[name] = ("no cost graph with byte annotations — "
                                 "memory certificate unavailable")
            continue
        PASSES[name](ctx, rep)
        rep.passes_run.append(name)
    return rep


def analyze_plan(plan: Any, *, graph: Any = None) -> DiagnosticReport:
    """Verify a :class:`~repro_torch.api.PartitionPlan`: artifact-level checks
    (schema version, fingerprint/graph drift) plus every pass
    :func:`analyze` can run with what the plan has bound.

    A fingerprint or node-count mismatch degrades to structural-only
    verification (interpreting a schedule against the wrong program
    would produce garbage diagnostics) — the mismatch itself is the
    error-severity finding.
    """
    from ..api import KNOWN_SCHEMA_VERSIONS
    traced = getattr(plan, "traced", None)
    g = graph if graph is not None else (
        traced.graph if traced is not None else None)
    prog = traced.program if traced is not None else None
    pre: list[Diagnostic] = []
    if plan.schema_version not in KNOWN_SCHEMA_VERSIONS:
        pre.append(Diagnostic(
            code=E.RP033_FINGERPRINT_DRIFT, severity=ERROR,
            message=f"plan schema version {plan.schema_version!r} is not "
                    f"one of {list(KNOWN_SCHEMA_VERSIONS)}",
            pass_name="artifact"))
    if traced is not None and traced.fingerprint != plan.fingerprint:
        pre.append(Diagnostic(
            code=E.RP033_FINGERPRINT_DRIFT, severity=ERROR,
            message=f"bound trace fingerprint {traced.fingerprint[:16]}… "
                    f"does not match the plan's {plan.fingerprint[:16]}… — "
                    f"the model, shapes, or cost model changed",
            pass_name="artifact"))
        prog, g = None, None
    if g is not None and getattr(g, "n", plan.n) != plan.n:
        pre.append(Diagnostic(
            code=E.RP032_PLACEMENT_HOLE, severity=ERROR,
            message=f"graph has {g.n} nodes but the plan's assignment "
                    f"covers {plan.n}", pass_name="artifact"))
        prog, g = None, None
    pred = plan.peak_mem
    rep = analyze(
        prog, plan.assignment, plan.k, graph=g,
        mem_caps=plan.devices.mem_caps() if plan.devices is not None
        else None,
        feasible=bool(plan.report.feasible),
        predicted_peaks=pred if getattr(pred, "size", 0) else None)
    rep.passes_run.insert(0, "artifact")
    rep.diagnostics[:0] = pre
    return rep
