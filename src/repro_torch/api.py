"""Plan-centric facade: trace → partition → plan → execute (the port's
side of the reference's ``repro/api.py``).

    from repro_torch import api

    traced = api.trace(step_fn, params, batch, record=True)
    plan = api.partition(traced, devices=4, memory=20e9)
    plan.save("step.plan.json")          # JSON header + npz assignment
    plan = api.PartitionPlan.load("step.plan.json", traced=traced)
    out = plan.execute(params, batch)    # segments as CUDA graphs
    # fewer devices than PEs? alias explicitly:
    #   plan.execute(params, batch, device_map=[0] * plan.k)
    # a plan of the paged decode step (serving.partition_for_serving):
    engine = plan.serve(cfg, params, device_map=api.fold_device_map(plan.k))

:func:`trace` always returns a :class:`TracedModel`; :func:`partition`
always returns a :class:`PartitionPlan` whose :class:`PlanReport`
captures per-stage timings and counters. A plan carries the cost
graph's content fingerprint, so a stale plan is never applied to a model
it was not computed for.

The artifact is the reference's: the same ``PLAN_FORMAT``, schema
version, npz payload and sha256, and the same RP101 / RP102 / RP103
checks, so a plan saved by either package loads in the other.
:meth:`PartitionPlan.verify` runs the static verifier
(:mod:`repro_torch.analysis`), which :meth:`~PartitionPlan.save` and
:meth:`~PartitionPlan.execute` run strictly, as the reference's do.
:meth:`~PartitionPlan.execute` runs the op-by-op interpreter or the
segment runtime (:mod:`repro_torch.core.runtime`), and with ``trace=``
writes the measured and predicted segment lanes
(:mod:`repro_torch.obs.trace`). :meth:`~PartitionPlan.serve` builds a
:class:`~repro_torch.serving.ServingEngine` whose decode steps run
through the plan. :func:`calibrate` measures the traced program's ops
and the card's copies (:mod:`repro_torch.profiling`),
:meth:`TracedModel.annotate` re-prices the graph from the measurements,
and :meth:`PartitionPlan.accuracy_report` scores a plan's predictions
against the card.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from . import resolve_device
from .core import errors as _E
from .core.costmodel import H100, DeviceModel
from .core.errors import PlanValidationError
from .core.executor import TracedProgram, execute as _execute
from .core.graph import CostGraph, Placement
from .core.partitioner import PardnnOptions, pardnn_partition
from .core.tracing import trace_cost_graph

PLAN_FORMAT = "repro-partition-plan"
PLAN_SCHEMA_VERSION = 1
KNOWN_SCHEMA_VERSIONS = (1,)

RUNTIMES = ("compiled", "interpret")


def _jsonable(x):
    """Recursively convert numpy scalars/arrays and tuples so the value
    round-trips through JSON *unchanged* (tuples become lists up front,
    matching what json.load hands back)."""
    if isinstance(x, Mapping):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return [_jsonable(v) for v in x.tolist()]
    if isinstance(x, (np.bool_, bool)):
        return bool(x)
    if isinstance(x, (np.integer, int)):
        return int(x)
    if isinstance(x, (np.floating, float)):
        return float(x)
    return x


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------
@dataclass
class DeviceSpec:
    """Target devices for a partition.

    Attributes:
        count: Number of (homogeneous) devices K.
        memory: Per-device capacity in bytes — scalar, length-K sequence,
            or None (no Step-2 memory enforcement).
        torch_devices: Concrete torch devices the plan's PEs run on.
    """
    count: int
    memory: float | Sequence[float] | None = None
    torch_devices: list | None = None

    @classmethod
    def resolve(cls, devices, memory=None) -> "DeviceSpec":
        if isinstance(devices, DeviceSpec):
            if memory is not None and devices.memory is None:
                return cls(devices.count, memory, devices.torch_devices)
            return devices
        if isinstance(devices, (int, np.integer)):
            return cls(int(devices), memory)
        # a concrete list of torch devices
        devs = list(devices)
        return cls(len(devs), memory, devs)

    def mem_caps(self) -> np.ndarray | float | None:
        if self.memory is None:
            return None
        if np.isscalar(self.memory):
            return float(self.memory)
        return np.asarray(self.memory, dtype=np.float64)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------
@dataclass
class TracedModel:
    """A traced computation: cost graph + optional executable program."""
    graph: CostGraph
    program: TracedProgram | None
    fingerprint: str
    # the device model the costs were derived with
    device_model: DeviceModel | None = None

    @property
    def n(self) -> int:
        return self.graph.n

    def annotate(self, profile) -> "TracedModel":
        """Re-annotate this trace's cost graph from a
        :class:`~repro_torch.profiling.CalibrationProfile` (in place).

        Node compute costs are replaced by the profile's *measured*
        per-signature seconds (dispatch-corrected) where the signature
        was profiled, and by the calibrated device model's roofline
        otherwise; edge comm costs are re-priced through the fitted
        alpha-beta model (payload bytes are recovered exactly by
        inverting the original model's ``comm_seconds``). Compute costs
        are then rescaled by the profile's ``fusion_factor``: what one
        replay of the whole program as one segment achieves against the
        summed per-op costs, measured independently of any partition.
        The graph fingerprint changes: existing plans for the
        un-annotated costs no longer bind (RP102) and must be
        re-partitioned, which is the point.
        """
        from .profiling.opbench import graph_signatures
        g = self.graph
        old = self.device_model
        if old is None:
            raise ValueError("annotate() needs the device model the "
                             "trace was priced with (TracedModel."
                             "device_model) to invert edge costs")
        if g.op_flops is None or g.op_bytes is None:
            raise ValueError("cost graph has no op_flops/op_bytes "
                             "annotations: re-trace with "
                             "repro_torch.api.trace")
        model = profile.device_model(base=old)
        flops = np.asarray(g.op_flops, dtype=np.float64)
        bts = np.asarray(g.op_bytes, dtype=np.float64)
        comp = np.maximum(
            flops / (model.peak_flops * model.flop_efficiency),
            bts / model.hbm_bw)
        measured = profile.op_seconds_by_signature()
        if measured:
            for i, sig in enumerate(graph_signatures(g)):
                t = measured.get(sig)
                if t is not None:
                    comp[i] = t
        # the measured per-op seconds and the roofline fallback both
        # describe ops run one at a time: rescale to what one replay of
        # the program achieves
        comp *= float(getattr(profile, "fusion_factor", 1.0))
        g.comp = comp
        for adj in (g.out_edges, g.in_edges):
            for u, edges in enumerate(adj):
                adj[u] = [
                    (v, model.comm_seconds(
                        max(c - old.link_latency, 0.0) * old.link_bw))
                    for v, c in edges]
        g._invalidate()
        self.device_model = model
        self.fingerprint = g.fingerprint()
        return self


def _resolve_calibration(calibration):
    """calibration= argument -> CalibrationProfile | None. Accepts a
    profile object, a path, or (when None) the ``REPRO_CALIBRATION``
    environment variable pointing at a saved artifact. A profile whose
    device fingerprint does not match this environment is applied but
    *warned about*: measured costs do not transfer across hardware; pass
    ``CalibrationProfile.load(path, expect_device=True)`` to make the
    mismatch a hard error instead."""
    if calibration is None:
        calibration = os.environ.get("REPRO_CALIBRATION") or None
    if calibration is None:
        return None
    from .profiling.artifact import (CalibrationProfile,
                                     current_device_fingerprint)
    if isinstance(calibration, str):
        calibration = CalibrationProfile.load(calibration)
    here = current_device_fingerprint()
    if calibration.device_fingerprint != here:
        import warnings
        warnings.warn(
            f"calibration profile was measured on "
            f"{calibration.device_fingerprint!r} but this environment "
            f"is {here!r}: measured costs may not transfer; re-run "
            f"repro_torch.api.calibrate on this hardware", stacklevel=3)
    return calibration


def trace(fn: Callable, *example_args, record: bool = False,
          dev: DeviceModel = H100, params_residual: bool = True,
          autograd: bool = False, calibration=None) -> TracedModel:
    """Trace ``fn(*example_args)`` into a :class:`TracedModel`.

    With ``record=True`` the node-level program is captured as well. The
    graph fingerprint is computed here once and reused for every plan
    produced from this trace. The trace runs on fake tensors: ``fn`` is
    not run. ``autograd=True`` traces a function that differentiates
    with ``torch.autograd``, such as a training step
    (:func:`repro_torch.conformance.make_train_step`), its backward
    included.

    ``calibration`` (a :class:`~repro_torch.profiling.
    CalibrationProfile`, a path to a saved one, or, when unset, the
    ``REPRO_CALIBRATION`` environment variable) overlays measured device
    parameters on ``dev`` before pricing, so the graph is annotated with
    calibrated costs from the start; :meth:`TracedModel.annotate`
    additionally patches in the per-op measured seconds afterwards.
    """
    profile = _resolve_calibration(calibration)
    if profile is not None:
        dev = profile.device_model(base=dev)
    res = trace_cost_graph(fn, *example_args, dev=dev,
                           params_residual=params_residual, record=record,
                           autograd=autograd)
    g, prog = res if record else (res, None)
    return TracedModel(graph=g, program=prog, fingerprint=g.fingerprint(),
                       device_model=dev)


def fold_device_map(k: int, devices=None) -> list[int] | None:
    """pe -> device-index aliasing for running a ``k``-PE plan on fewer
    devices (round-robin), or None when enough devices exist. ``devices``
    defaults to every visible CUDA device, and raises when there is
    none."""
    if devices is None:
        resolve_device(None)
        devices = range(torch.cuda.device_count())
    n = len(devices)
    return None if n >= k else [i % n for i in range(k)]


def calibrate(traced, *example_args, **kwargs):
    """Measure real op and copy costs and fit the device model: the
    facade name for :func:`repro_torch.profiling.run_calibration` (see
    there for the full signature; ``device`` defaults to ``cuda``).
    Returns a :class:`~repro_torch.profiling.CalibrationProfile`."""
    from .profiling import run_calibration
    return run_calibration(traced, *example_args, **kwargs)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
@dataclass
class PlanReport:
    """Structured account of how a plan was produced and what it costs.

    ``stage_seconds`` holds the per-stage wall times (slice / map /
    refine / step2 / total); ``counters`` the mapping, refinement and
    Step-2 movement counters from the partitioner; ``runtime`` the last
    compiled execution's stats; ``accuracy`` the predicted-against-
    measured scorecard of :meth:`PartitionPlan.accuracy_report`;
    ``diagnostics`` the verifier's summary; ``serving`` the stats of the
    last plan-served engine run to a drain. All round-trip unchanged
    through the plan header.
    """
    makespan_s: float
    peak_mem_bytes: list
    feasible: bool
    moved_nodes: int
    stage_seconds: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    runtime: dict = field(default_factory=dict)
    accuracy: dict = field(default_factory=dict)
    diagnostics: dict = field(default_factory=dict)
    serving: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"makespan_s": self.makespan_s,
                "peak_mem_bytes": self.peak_mem_bytes,
                "feasible": self.feasible,
                "moved_nodes": self.moved_nodes,
                "stage_seconds": self.stage_seconds,
                "counters": self.counters,
                "runtime": self.runtime,
                "accuracy": self.accuracy,
                "diagnostics": self.diagnostics,
                "serving": self.serving}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanReport":
        return cls(makespan_s=float(d["makespan_s"]),
                   peak_mem_bytes=list(d["peak_mem_bytes"]),
                   feasible=bool(d["feasible"]),
                   moved_nodes=int(d["moved_nodes"]),
                   stage_seconds=dict(d.get("stage_seconds", {})),
                   counters=dict(d.get("counters", {})),
                   runtime=dict(d.get("runtime", {})),
                   accuracy=dict(d.get("accuracy", {})),
                   diagnostics=dict(d.get("diagnostics", {})),
                   serving=dict(d.get("serving", {})))

    @classmethod
    def from_placement(cls, p: Placement) -> "PlanReport":
        timing_keys = ("slice_s", "map_s", "refine_s", "step2_s", "total_s")
        stage_seconds = {k: float(p.stats[k]) for k in timing_keys
                         if k in p.stats}
        counters = _jsonable({k: v for k, v in p.stats.items()
                              if k not in timing_keys})
        peaks = [] if p.peak_mem is None else \
            [float(x) for x in np.asarray(p.peak_mem)]
        return cls(makespan_s=float(p.makespan), peak_mem_bytes=peaks,
                   feasible=bool(p.feasible), moved_nodes=int(p.moved_nodes),
                   stage_seconds=stage_seconds, counters=counters)


# ---------------------------------------------------------------------------
# the plan artifact
# ---------------------------------------------------------------------------
def _npz_path(path: str) -> str:
    stem, ext = os.path.splitext(path)
    return (stem if ext.lower() in (".json", ".plan") else path) + ".npz"


@dataclass
class PartitionPlan:
    """The durable placement artifact (the paper's "single file").

    Produced by :func:`partition`; persisted by :meth:`save` as a JSON
    header (schema version, graph fingerprint, report, metadata) plus an
    npz payload (assignment, per-device peaks, op names); reloaded by
    :meth:`load` with schema and fingerprint validation. :meth:`bind`
    attaches a fresh trace after checking it is the same computation.
    """
    assignment: np.ndarray                # int64, node -> device
    k: int
    fingerprint: str
    report: PlanReport
    devices: DeviceSpec | None = None
    meta: dict = field(default_factory=dict)
    names: np.ndarray | None = None       # per-node op names (optional)
    schema_version: int = PLAN_SCHEMA_VERSION
    traced: TracedModel | None = None     # not serialized

    # -- convenience views --------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.assignment.shape[0])

    @property
    def makespan(self) -> float:
        return self.report.makespan_s

    @property
    def peak_mem(self) -> np.ndarray:
        return np.asarray(self.report.peak_mem_bytes, dtype=np.float64)

    @property
    def feasible(self) -> bool:
        return self.report.feasible

    def summary(self) -> str:
        r = self.report
        peaks = ", ".join(f"{m / 1e6:.0f}MB" for m in r.peak_mem_bytes)
        return (f"PartitionPlan: {self.n} ops on {self.k} devices, "
                f"makespan {r.makespan_s * 1e3:.3f} ms, "
                f"feasible={r.feasible}, moved={r.moved_nodes}, "
                f"peaks [{peaks}]")

    # -- static verification ------------------------------------------------
    def verify(self, *, strict: bool = False):
        """Statically verify this plan (:mod:`repro_torch.analysis`):
        placement holes, schedule liveness (use-after-free / double-free
        / bad donation), transfer completeness, deadlock/acyclicity, and,
        with a bound trace, the per-device peak-memory certificate.
        Nothing executes.

        Returns the :class:`~repro_torch.analysis.DiagnosticReport`
        (cached until the assignment or bound trace changes) and records
        its summary in ``report.diagnostics``. With ``strict=True``,
        error-severity findings raise :class:`PlanValidationError` (code
        RP107): the mode :meth:`save` and :meth:`execute` use.
        """
        from .analysis import analyze_plan
        key = (id(self.traced),
               None if self.traced is None else id(self.traced.program),
               hashlib.sha256(np.ascontiguousarray(
                   self.assignment, dtype=np.int64).tobytes()).hexdigest(),
               self.k)
        cached = getattr(self, "_verify_cache", None)
        if cached is not None and cached[0] == key:
            report = cached[1]
        else:
            report = analyze_plan(self)
            self._verify_cache = (key, report)
            self.report.diagnostics = report.summary_dict()
        if strict and report.has_errors():
            raise PlanValidationError(
                "static plan verification failed:\n"
                + report.render(max_findings=10),
                code=_E.RP107_VERIFICATION_FAILED)
        return report

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> str:
        """Write the plan: ``path`` (JSON header) + sibling ``.npz``.

        The header records the schema version, graph fingerprint, a
        sha256 of the assignment payload, the full report, and user
        metadata; the npz holds the arrays bit-for-bit. Returns ``path``.

        The plan is statically verified first (:meth:`verify`): a plan
        carrying error-severity diagnostics is refused rather than
        persisted; the diagnostic summary is serialized in the header's
        report.
        """
        self.verify(strict=True)
        apath = _npz_path(path)
        assignment = np.ascontiguousarray(self.assignment, dtype=np.int64)
        arrays = {"assignment": assignment,
                  "peak_mem": np.asarray(self.report.peak_mem_bytes,
                                         dtype=np.float64)}
        if self.names is not None:
            arrays["names"] = np.asarray(self.names)
        with open(apath, "wb") as f:
            np.savez(f, **arrays)
        header = {
            "format": PLAN_FORMAT,
            "schema_version": self.schema_version,
            "graph_fingerprint": self.fingerprint,
            "num_nodes": self.n,
            "devices": self.k,
            "memory": _jsonable(self.devices.memory) if self.devices
                      else None,
            "assignment_file": os.path.basename(apath),
            "assignment_sha256": hashlib.sha256(
                assignment.tobytes()).hexdigest(),
            "report": self.report.to_dict(),
            "meta": _jsonable(self.meta),
        }
        with open(path, "w") as f:
            json.dump(header, f, indent=1)
        return path

    @classmethod
    def load(cls, path: str, traced: TracedModel | None = None,
             graph: CostGraph | None = None) -> "PartitionPlan":
        """Load and validate a plan artifact.

        Raises :class:`PlanValidationError` on an unknown schema version
        (RP101), a corrupted assignment payload (RP103), or — when
        ``traced``/``graph`` is supplied — a graph-fingerprint mismatch
        (RP102: the plan was computed for a different model).
        """
        with open(path) as f:
            header = json.load(f)
        if header.get("format") != PLAN_FORMAT:
            raise PlanValidationError(
                f"{path}: not a {PLAN_FORMAT} file "
                f"(format={header.get('format')!r})")
        ver = header.get("schema_version")
        if ver not in KNOWN_SCHEMA_VERSIONS:
            raise PlanValidationError(
                f"{path}: unknown plan schema version {ver!r}; this build "
                f"supports {list(KNOWN_SCHEMA_VERSIONS)} — regenerate the "
                f"plan with repro_torch.api.partition or upgrade the "
                f"library", code=_E.RP101_SCHEMA_UNKNOWN)
        apath = os.path.join(os.path.dirname(os.path.abspath(path)),
                             header["assignment_file"])
        with np.load(apath) as z:
            assignment = np.asarray(z["assignment"], dtype=np.int64)
            peak_mem = np.asarray(z["peak_mem"], dtype=np.float64)
            names = np.asarray(z["names"]) if "names" in z.files else None
        digest = hashlib.sha256(
            np.ascontiguousarray(assignment).tobytes()).hexdigest()
        if digest != header["assignment_sha256"]:
            raise PlanValidationError(
                f"{path}: assignment payload corrupted "
                f"(sha256 {digest[:12]}… != header "
                f"{header['assignment_sha256'][:12]}…)",
                code=_E.RP103_PAYLOAD_CORRUPT)
        if assignment.shape[0] != header["num_nodes"]:
            raise PlanValidationError(
                f"{path}: assignment has {assignment.shape[0]} nodes, "
                f"header says {header['num_nodes']}",
                code=_E.RP103_PAYLOAD_CORRUPT)
        report = PlanReport.from_dict(header["report"])
        # npz carries the peaks bit-for-bit; trust it over the JSON floats
        report.peak_mem_bytes = [float(x) for x in peak_mem]
        mem = header.get("memory")
        plan = cls(assignment=assignment, k=int(header["devices"]),
                   fingerprint=header["graph_fingerprint"], report=report,
                   devices=DeviceSpec(int(header["devices"]), mem),
                   meta=dict(header.get("meta") or {}), names=names,
                   schema_version=int(ver))
        if traced is not None or graph is not None:
            plan.bind(traced if traced is not None
                      else TracedModel(graph, None, graph.fingerprint()))
        return plan

    # -- binding ------------------------------------------------------------
    def bind(self, traced: TracedModel) -> "PartitionPlan":
        """Attach a fresh trace to this plan, validating that it is the
        same computation the plan was produced for."""
        if traced.fingerprint != self.fingerprint:
            raise PlanValidationError(
                f"graph fingerprint mismatch: plan was computed for "
                f"{self.fingerprint[:16]}…, got {traced.fingerprint[:16]}… "
                f"— the model, shapes, or cost model changed; re-run "
                f"repro_torch.api.partition",
                code=_E.RP102_FINGERPRINT_MISMATCH)
        if traced.graph.n != self.n:
            raise PlanValidationError(
                f"graph has {traced.graph.n} nodes, plan has {self.n}",
                code=_E.RP102_FINGERPRINT_MISMATCH)
        self.traced = traced
        return self

    # -- execution ----------------------------------------------------------
    def _torch_devices(self, devices=None, device_map=None) -> list:
        """The ``torch.device`` of each PE: ``devices`` (default: the
        DeviceSpec's, else every visible CUDA device, raising when there
        is none), expanded through ``device_map``."""
        if devices is None and self.devices is not None:
            devices = self.devices.torch_devices
        if devices is None:
            resolve_device(None)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if device_map is not None:
            device_map = [int(i) for i in device_map]
            if len(device_map) < self.k:
                raise PlanValidationError(
                    f"device_map has {len(device_map)} entries, plan "
                    f"uses {self.k} PEs", code=_E.RP104_DEVICE_MISMATCH)
            bad = [i for i in device_map if i < 0 or i >= len(devices)]
            if bad:
                raise PlanValidationError(
                    f"device_map entries {bad} out of range: "
                    f"{len(devices)} devices available (indices "
                    f"0..{len(devices) - 1})",
                    code=_E.RP104_DEVICE_MISMATCH)
            devices = [devices[i] for i in device_map]
        if len(devices) < self.k:
            raise PlanValidationError(
                f"plan uses {self.k} PEs but only {len(devices)} devices "
                f"are available — pass device_map= (pe -> device index, "
                f"e.g. device_map=[0]*{self.k} to fold onto one device) "
                f"to alias PEs explicitly", code=_E.RP104_DEVICE_MISMATCH)
        return devices

    def execute(self, *args, devices=None, device_map=None,
                runtime: str | None = None, donate: bool = True,
                mode: str | None = None, static_argnums=None,
                trace: str | None = None, **kwargs):
        """Run the recorded program under this placement (the paper's
        "placement file → execution engine" path).

        Args:
            devices: the torch devices the PEs run on (default: every
                visible CUDA device; raises when there is none). A plan
                with more PEs than devices raises; alias PEs explicitly
                via ``device_map``. ``["cpu"]`` runs on the CPU.
            device_map: pe -> device-index list realizing the placement
                on fewer devices (``[0] * plan.k`` folds every PE onto
                one device, each PE keeping its own stream; the PEs of
                one device capture into one graph pool and replay in
                capture order).
            runtime: ``"compiled"`` (default; the segment runtime: one
                CUDA graph per segment, liveness-driven freeing) or
                ``"interpret"`` (op by op). Overridable via the
                ``REPRO_RUNTIME`` env var.
            donate: donate each segment's dead inputs, so that its
                outputs may take their memory, and run the functional
                writes into them in place (default True, as the
                reference's); ``False`` frees by liveness alone. Both
                give the same bits; neither writes into the caller's
                tensors.
            mode: compiled dispatch mode: ``"async"`` (overlapped; the
                default) or ``"sync"`` (synchronised per segment).
                ``None`` resolves the ``REPRO_RUNTIME_SYNC=1`` escape
                hatch. Both replay the same graphs and are
                bit-identical; ``report.runtime["mode"]`` records which
                one produced the timings.
            static_argnums: positional arguments the CUDA graphs read in
                place (default: ``plan.meta["static_argnums"]``, which
                ``serving.partition_for_serving`` sets to ``[0]``, the
                parameters, else none). A later call must pass the same
                tensors there, or it raises. Every other input leaf is
                copied into a buffer the runtime owns at each call, so
                no call writes into its arguments.
            trace: write a Chrome trace-event / Perfetto JSON file to
                this path (open in ui.perfetto.dev). The call runs one
                :meth:`~repro_torch.core.runtime.CompiledRuntime.
                measure_timeline` pass and merges the **measured**
                segment lanes with the overlap emulator's **predicted**
                lanes for the same segments (:mod:`repro_torch.obs.
                trace`). Compiled runtime only.

        The compiled runtime is cached on the plan (rebuilt only when
        the devices, ``donate`` or ``static_argnums`` change) and its
        :class:`~repro_torch.core.runtime.RuntimeStats` land in
        ``report.runtime``. Requires a bound trace recorded with
        ``record=True``.
        """
        if self.traced is None or self.traced.program is None:
            raise PlanValidationError(
                "plan has no executable program: trace with record=True "
                "and partition (or PartitionPlan.bind) before execute()",
                code=_E.RP106_PLAN_NOT_EXECUTABLE)
        self.verify(strict=True)
        if runtime is None:
            runtime = os.environ.get("REPRO_RUNTIME", "compiled")
        if runtime not in RUNTIMES:
            raise ValueError(f"unknown runtime {runtime!r}; "
                             f"have {list(RUNTIMES)}")
        devs = self._torch_devices(devices, device_map)
        if runtime == "interpret":
            if trace is not None:
                raise ValueError("trace= needs the compiled runtime's "
                                 "measured timeline; drop "
                                 "runtime='interpret'")
            return _execute(self.traced.program, self.assignment, devs,
                            *args, **kwargs)
        from .core.runtime import CompiledRuntime, resolve_runtime_mode
        if static_argnums is None:
            static_argnums = self.meta.get("static_argnums", ())
        static_argnums = tuple(int(i) for i in static_argnums)
        key = (tuple(devs[:self.k]), static_argnums, bool(donate))
        rt = getattr(self, "_compiled_runtime", None)
        if rt is None or rt[0] != key:
            rt = (key, CompiledRuntime(self.traced.program,
                                       self.assignment, devs[:self.k],
                                       donate=donate,
                                       static_argnums=static_argnums))
            self._compiled_runtime = rt
        # mode is resolved per call (not cached in the key): the same
        # captured segments serve both dispatch modes
        rt[1].mode = resolve_runtime_mode(mode)
        if trace is not None:
            from .obs.trace import build_plan_trace
            out, timeline = rt[1].measure_timeline(*args, **kwargs)
            self.report.runtime = rt[1].stats.to_dict()
            build_plan_trace(self, rt[1], timeline).save(trace)
            return out
        out = rt[1](*args, **kwargs)
        self.report.runtime = rt[1].stats.to_dict()
        return out

    def accuracy_report(self, *args, devices=None, device_map=None,
                        reps: int = 3, donate: bool = True,
                        static_argnums=None, **kwargs) -> dict:
        """Score the Step-2 emulator's predictions against the compiled
        runtime's measurements: the closed predict-execute loop.

        Runs the plan through the segment runtime in per-segment
        profiling mode (``reps`` serialised passes, medians taken; on the
        card each segment's seconds come from timing events around its
        graph replay), runs the emulator on the same placement, and
        compares stage by stage (a *stage* = one segment): predicted
        seconds (sum of annotated node costs) against measured seconds,
        as absolute percentage error. The scorecard lands in
        ``report.accuracy`` (serialized with the plan) and is returned.

        A huge MAPE is not a bug: it is the measurement that tells you
        the cost model is wrong for this hardware. Calibrate
        (:func:`calibrate`, then :meth:`TracedModel.annotate`),
        re-partition, and score again to close the loop.

        Sync and async samples are never mixed: per-stage timings come
        from the serialised profiling mode, while the overlap scoring
        runs one *async* timeline pass
        (:meth:`~repro_torch.core.runtime.CompiledRuntime.
        measure_timeline`) and compares its measured makespan against
        the overlap emulator's segment-level prediction.
        ``timing_modes`` labels which mode produced each number.
        ``devices``, ``device_map``, ``donate`` and ``static_argnums``
        are :meth:`execute`'s.
        """
        from .core.emulator import (emulate, emulate_overlap,
                                    segment_cost_graph,
                                    serialized_makespan)
        from .profiling.opbench import profile_segments

        if self.traced is None or self.traced.program is None:
            raise PlanValidationError(
                "accuracy_report needs a bound trace recorded with "
                "record=True (the plan must be executable)",
                code=_E.RP106_PLAN_NOT_EXECUTABLE)
        # build (or reuse) the compiled runtime: this call runs the
        # program end to end and pays capture, so profile_segments can
        # skip its own warm-up pass
        self.execute(*args, devices=devices, device_map=device_map,
                     runtime="compiled", donate=donate,
                     static_argnums=static_argnums, **kwargs)
        rt = self._compiled_runtime[1]
        prof = profile_segments(rt, *args, reps=reps, warmup=False,
                                **kwargs)
        g = self.traced.graph
        comp = np.asarray(g.comp, dtype=np.float64)
        segments = rt.schedule.segments
        pred = np.asarray([float(np.sum(comp[list(s.nodes)]))
                           for s in segments])
        meas = np.asarray(prof["seconds"], dtype=np.float64)
        disp = np.asarray(prof["dispersion"], dtype=np.float64)
        ape = np.abs(pred - meas) / np.maximum(meas, 1e-12)
        # score only stages/devices with measurable duration: sub-2us
        # times are clock noise. None (not NaN: the scorecard must stay
        # valid JSON) when nothing clears the floor.
        scored = meas > 2e-6
        mape = float(np.mean(ape[scored]) * 100) if scored.any() else None
        k = max(self.k, 1)
        pred_dev = np.zeros(k)
        meas_dev = np.zeros(k)
        for s, p, m in zip(segments, pred, meas):
            pred_dev[s.device] += p
            meas_dev[s.device] += m
        dev_scored = meas_dev > 2e-6
        dev_ape = np.abs(pred_dev - meas_dev) / np.maximum(meas_dev, 1e-12)
        sched = emulate(g, self.assignment, self.k)
        wall = float(np.median(prof["wall_seconds"]))
        # one async timeline pass: measured per-segment dispatch/ready/
        # done envelope and async wall, scored against the overlap
        # emulator's segment-level makespan prediction
        prev_mode = rt.mode
        try:
            rt.mode = "async"
            _, timeline = rt.measure_timeline(*args, **kwargs)
        finally:
            rt.mode = prev_mode
        dm = self.traced.device_model
        overlap_pred = serial_pred = None
        if dm is not None:
            sg, seg_assign = segment_cost_graph(
                self.traced.program, rt.schedule, g, dm)
            ov = emulate_overlap(sg, seg_assign, self.k,
                                 comm_streams=dm.comm_streams)
            overlap_pred = float(ov.makespan)
            serial_pred = float(serialized_makespan(sg, seg_assign))
        async_wall = float(timeline["makespan_s"])
        result = {
            "num_stages": len(segments),
            "stages_scored": int(np.count_nonzero(scored)),
            "reps": int(reps),
            "per_stage": [
                {"stage": int(s.sid), "device": int(s.device),
                 "nodes": len(s.nodes), "predicted_s": float(p),
                 "measured_s": float(m), "dispersion": float(d),
                 "ape_pct": float(a * 100)}
                for s, p, m, d, a in zip(segments, pred, meas, disp, ape)],
            "stage_mape_pct": mape,
            "per_device_ape_pct": [float(a * 100) if s else None
                                   for a, s in zip(dev_ape, dev_scored)],
            "devices_scored": int(np.count_nonzero(dev_scored)),
            "device_mape_pct": (float(np.mean(dev_ape[dev_scored]) * 100)
                                if dev_scored.any() else None),
            "predicted_makespan_s": float(sched.makespan),
            "measured_wall_s": wall,
            "makespan_ratio": (wall / float(sched.makespan)
                               if sched.makespan > 0 else None),
            # overlap scoring: async samples only, never mixed with the
            # sync per-stage numbers above (see timing_modes)
            "timing_modes": {"per_stage": "sync",
                             "measured_wall_s": "sync",
                             "timeline": str(timeline["mode"]),
                             "measured_async_wall_s": "async"},
            "predicted_overlap_makespan_s": overlap_pred,
            "predicted_serialized_makespan_s": serial_pred,
            "measured_async_wall_s": async_wall,
            "overlap_makespan_ratio": (
                async_wall / overlap_pred
                if overlap_pred else None),
            "serialized_makespan_ratio": (
                wall / serial_pred if serial_pred else None),
            "timeline": timeline,
            "cost_model": (self.traced.device_model.name
                           if self.traced.device_model else None),
        }
        self.report.accuracy = result
        return result

    def benchmark_runtimes(self, *args, devices=None, device_map=None,
                           reps: int = 3, **kwargs) -> dict:
        """Time both execution engines on this plan with the same inputs.

        One interpreter run, one compiled run paying capture, then the
        steady-state compiled path measured by the robust estimator
        (:mod:`repro_torch.profiling.measure`: median-of-k with outlier
        rejection and noisy-window retries, ``reps`` samples per
        attempt), async and sync. Every sample is the host's clock
        around a call and a wait for the card. Returns timings (with
        sample dispersion), speedup, segment/transfer counters, output
        drift, and measured-vs-predicted per-device peak bytes.
        ``kwargs`` go to :meth:`execute` (``static_argnums``, ...).
        """
        import time

        from .profiling.measure import MeasureSpec, measure_call, synchronize
        from .tree import tree_flatten

        def _timed(runtime):
            t0 = time.perf_counter()
            out = synchronize(self.execute(*args, devices=devices,
                                           device_map=device_map,
                                           runtime=runtime, **kwargs))
            return out, time.perf_counter() - t0

        def _drift(x, y) -> float:
            d = 0.0
            for a, b in zip(tree_flatten(x)[0], tree_flatten(y)[0]):
                if isinstance(a, torch.Tensor) and a.numel():
                    d = max(d, float((a.double() - b.double()).abs().max()))
            return d

        out_i, interp_s = _timed("interpret")
        out_c, first_s = _timed("compiled")
        m = measure_call(
            lambda: self.execute(*args, devices=devices,
                                 device_map=device_map,
                                 runtime="compiled", mode="async",
                                 **kwargs),
            spec=MeasureSpec(warmup=0, reps=max(int(reps), 2)),
            sync=synchronize)
        out_c = m.result
        best = m.seconds
        rt = dict(self.report.runtime)
        # the serialised escape hatch, same captured segments: the
        # async-vs-sync delta is the measured overlap speedup
        m_sync = measure_call(
            lambda: self.execute(*args, devices=devices,
                                 device_map=device_map,
                                 runtime="compiled", mode="sync",
                                 **kwargs),
            spec=MeasureSpec(warmup=0, reps=max(int(reps), 2)),
            sync=synchronize)
        sync_s = m_sync.seconds
        sync_drift = _drift(m_sync.result, out_c)
        drift = _drift(out_c, out_i)
        del out_i, out_c
        predicted = [float(x) for x in self.peak_mem]
        measured = list(rt.get("peak_live_bytes", []))
        # the full estimator evidence rides in report.runtime so it
        # serializes with the plan: a one-number speedup without its
        # dispersion is not diagnosable from artifacts alone
        timing_modes = {"async": m.to_dict(), "sync": m_sync.to_dict()}
        self.report.runtime = {**self.report.runtime,
                               "timing_modes": timing_modes}
        return {
            "timing_modes": timing_modes,
            "interpreter_s": interp_s,
            "compiled_first_call_s": first_s,
            "compiled_s": best,
            "compiled_dispersion": m.dispersion,
            "compiled_samples": int(m.samples.size),
            "timing_attempts": int(m.attempts),
            "timing_noisy": bool(m.noisy),
            "speedup": interp_s / best if best > 0 else float("inf"),
            "compiled_mode": rt.get("mode", "async"),
            "compiled_sync_s": sync_s,
            "compiled_sync_dispersion": m_sync.dispersion,
            "overlap_speedup": sync_s / best if best > 0 else float("inf"),
            "sync_async_drift": sync_drift,
            "prefetched_transfers": rt.get("prefetched_transfers", 0),
            "deferred_transfers": rt.get("deferred_transfers", 0),
            "compile_s": rt.get("compile_seconds", 0.0),
            "num_segments": rt.get("num_segments", 0),
            "segments_per_device": rt.get("segments_per_device", []),
            "transfers": rt.get("transfers", 0),
            "transfer_bytes": rt.get("transfer_bytes", 0.0),
            "freed_buffers": rt.get("freed_buffers", 0),
            "output_drift": drift,
            "predicted_peak_bytes": predicted,
            "measured_peak_bytes": measured,
            "measured_over_predicted": [
                (m / p if p else None)
                for m, p in zip(measured, predicted)],
        }

    def to_pipeline_stages(self, layer_costs, layer_mem, act_bytes: float,
                           num_stages: int | None = None,
                           mem_cap: float | None = None, **kw):
        """Bridge to the pipeline planner
        (:func:`repro_torch.pipeline.plan_stages`): contiguous stage
        boundaries for a layer chain, the stage count defaulting to this
        plan's K and the stage memory cap to its largest per-device
        capacity."""
        from .pipeline.pardnn_pp import plan_stages
        if num_stages is None:
            num_stages = self.k
        if mem_cap is None and self.devices is not None \
                and self.devices.memory is not None:
            m = self.devices.memory
            mem_cap = float(m) if np.isscalar(m) else float(np.max(m))
        return plan_stages(layer_costs, layer_mem, act_bytes=act_bytes,
                           num_stages=num_stages, mem_cap=mem_cap, **kw)

    def compare(self, baselines: Sequence[str] = ("rr", "topo"),
                graph: CostGraph | None = None) -> dict:
        """Run baseline partitioners on the same graph; returns
        ``{name: {"makespan_s": ..., "speedup": plan-vs-baseline}}``."""
        from .core.baselines import BASELINES
        g = graph if graph is not None else \
            (self.traced.graph if self.traced is not None else None)
        if g is None:
            raise ValueError("compare() needs a bound trace or graph=")
        out = {}
        for name in baselines:
            if name not in BASELINES:
                raise ValueError(f"unknown baseline {name!r}; "
                                 f"have {sorted(BASELINES)}")
            b = BASELINES[name](g, self.k)
            out[name] = {"makespan_s": float(b.makespan),
                         "speedup": float(b.makespan / self.makespan)
                         if self.makespan else float("nan")}
        return out

    # -- serving ------------------------------------------------------------
    def serve(self, cfg, params, *, devices=None, device_map=None,
              runtime: str | None = None, trace: str | None = None,
              device=None, **overrides):
        """Build a :class:`~repro_torch.serving.ServingEngine` deploying
        this plan: each paged KV pool leaf is allocated on the device
        of the PE the plan assigns its input node, and every decode step
        runs through :meth:`execute` (the compiled runtime replays the
        plan's CUDA-graph segments). Prefill runs on ``device`` (``None``
        means ``cuda``), where ``params`` live.

        The serving geometry (block_size / num_blocks / max_batch /
        max_len) defaults to what the plan was partitioned for
        (``meta["serving"]``, recorded by
        :func:`repro_torch.serving.partition_for_serving`); keyword
        ``overrides`` replace single values, but one that changes the
        decode step's shapes fails the fingerprint check when the engine
        binds the plan (RP102). ``trace`` names a Chrome trace-event JSON
        path the engine writes at drain time.
        """
        from .serving import ServingEngine
        geo = dict(self.meta.get("serving") or {})
        geo.update(overrides)
        if not geo:
            raise ValueError(
                "plan carries no serving geometry (meta['serving']) — "
                "build it with repro_torch.serving.partition_for_serving, "
                "or pass block_size/num_blocks/max_batch/max_len "
                "explicitly")
        return ServingEngine(cfg, params, plan=self, devices=devices,
                             device_map=device_map, runtime=runtime,
                             trace=trace, device=device, **geo)


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------
def partition(traced_or_graph: TracedModel | CostGraph,
              devices: DeviceSpec | int | Sequence = 1,
              memory: float | Sequence[float] | None = None,
              options: PardnnOptions | None = None,
              progress: Callable[[str, dict], None] | None = None,
              meta: dict | None = None) -> PartitionPlan:
    """Partition a traced model (or raw cost graph) into a
    :class:`PartitionPlan`.

    Args:
        traced_or_graph: A :class:`TracedModel` from :func:`trace`, or a
            bare finalized :class:`CostGraph`.
        devices: Device count, a :class:`DeviceSpec`, or a list of torch
            devices.
        memory: Per-device capacity in bytes (scalar or per-device);
            overrides nothing if the DeviceSpec already carries one.
        options: :class:`~repro_torch.core.partitioner.PardnnOptions`.
        progress: Optional ``progress(stage, info)`` callback, threaded
            through the partitioner's stages and Step-2 rounds.
        meta: Free-form JSON-serializable metadata stored in the plan
            header (arch name, serving geometry, …).
    """
    if isinstance(traced_or_graph, TracedModel):
        traced = traced_or_graph
    elif isinstance(traced_or_graph, CostGraph):
        g = traced_or_graph
        traced = TracedModel(graph=g, program=None,
                             fingerprint=g.fingerprint())
    else:
        raise TypeError(
            f"partition() takes a TracedModel or CostGraph, got "
            f"{type(traced_or_graph).__name__}")
    spec = DeviceSpec.resolve(devices, memory)
    placement = pardnn_partition(traced.graph, spec.count,
                                 mem_caps=spec.mem_caps(), options=options,
                                 progress=progress)
    return PartitionPlan(
        assignment=np.asarray(placement.assignment, dtype=np.int64),
        k=spec.count, fingerprint=traced.fingerprint,
        report=PlanReport.from_placement(placement), devices=spec,
        meta=dict(meta or {}),
        names=np.asarray(traced.graph.names) if traced.graph.names else None,
        traced=traced)


__all__ = [
    "trace", "partition", "calibrate", "fold_device_map", "TracedModel", "DeviceSpec",
    "PartitionPlan", "PlanReport", "PlanValidationError", "PardnnOptions",
    "PLAN_FORMAT", "PLAN_SCHEMA_VERSION", "RUNTIMES",
]
