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
through the plan.
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


def trace(fn: Callable, *example_args, record: bool = False,
          dev: DeviceModel = H100, params_residual: bool = True,
          autograd: bool = False) -> TracedModel:
    """Trace ``fn(*example_args)`` into a :class:`TracedModel`.

    With ``record=True`` the node-level program is captured as well. The
    graph fingerprint is computed here once and reused for every plan
    produced from this trace. The trace runs on fake tensors: ``fn`` is
    not run. ``autograd=True`` traces a function that differentiates
    with ``torch.autograd``, such as a training step
    (:func:`repro_torch.conformance.make_train_step`), its backward
    included.
    """
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


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
@dataclass
class PlanReport:
    """Structured account of how a plan was produced and what it costs.

    ``stage_seconds`` holds the per-stage wall times (slice / map /
    refine / step2 / total); ``counters`` the mapping, refinement and
    Step-2 movement counters from the partitioner; ``runtime`` the last
    compiled execution's stats; ``diagnostics`` the verifier's summary;
    ``serving`` the stats of the last plan-served engine run to a
    drain. ``accuracy`` is the reference's field, which the port does
    not fill yet; all round-trip unchanged through the plan header.
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
                one device, each PE keeping its own stream).
            runtime: ``"compiled"`` (default; the segment runtime: one
                CUDA graph per segment, liveness-driven freeing) or
                ``"interpret"`` (op by op). Overridable via the
                ``REPRO_RUNTIME`` env var.
            donate: accepted for parity with the reference; PyTorch has
                no donation, and it changes nothing.
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
        the devices or ``static_argnums`` change) and its
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
        key = (tuple(devs[:self.k]), static_argnums)
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
    "trace", "partition", "fold_device_map", "TracedModel", "DeviceSpec",
    "PartitionPlan", "PlanReport", "PlanValidationError", "PardnnOptions",
    "PLAN_FORMAT", "PLAN_SCHEMA_VERSION", "RUNTIMES",
]
