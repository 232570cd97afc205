"""Per-op / per-segment / per-link profiler over real devices (port of
``repro.profiling.opbench``).

The paper's ParDNN consumes graphs annotated from TensorFlow profiling
runs; this module is that measurement side for the port. Three probes,
all built on :mod:`.measure`:

* :func:`profile_ops` replays a recorded
  :class:`~repro_torch.core.executor.TracedProgram` node by node (the
  interpreter's ``run_node``), groups nodes into *signatures* (``name |
  FLOPs | bytes touched | output bytes``, derived from the cost graph
  alone so the same key is computable at annotation time) and robustly
  times one representative aten call per signature: the host's clock
  around the call and a wait for its device. A node the trace prices at
  no FLOPs and no bytes (a view: metadata only, no kernel, free inside a
  CUDA graph) is replayed but not timed, so its cost stays 0; the
  reference times its slices because a JAX slice is a copy. Values are
  freed by the program's liveness table, as the segment runtime frees
  them. A node
  whose op writes one of its inputs is timed on clones of its inputs and
  then run once on the real ones, so the replay's values are those of
  one run of the program.
* :func:`profile_transfers` times one copy over a ladder of payload
  sizes: the samples the alpha-beta transfer model is regressed from.
  Between two cards it is the peer copy the segment runtime issues
  between PEs on different cards; on one card it is a device-to-device
  copy on that card (PEs folded onto one card copy nothing, and a
  host-to-device copy would price every cross-PE edge at PCIe rate); on
  the CPU a host copy. :func:`transfer_probe` names which.
* :func:`profile_segments` runs a :class:`~repro_torch.core.runtime.
  CompiledRuntime` in its per-segment profiling mode (segments
  serialised; on the card each segment's seconds come from timing events
  around its graph replay) and reduces the samples to robust medians:
  the measured side of ``PartitionPlan.accuracy_report``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..core.executor import node_kwargs, run_node
from ..tree import tree_unflatten
from .measure import (DEFAULT_SPEC, MeasureSpec, Measurement, measure_call,
                      synchronize)

#: Default payload ladder for transfer profiling (bytes of float32): the
#: reference's, used on the CPU.
DEFAULT_TRANSFER_SIZES = (1 << 10, 1 << 13, 1 << 16, 1 << 19,
                          1 << 22, 1 << 24)

#: The ladder on a card: 4 KiB to 256 MiB. A card copies 16 MiB in less
#: than the ~20 us a host-timed call costs, so the reference's ladder
#: leaves the bandwidth in the noise: on an H100 80GB HBM3 at 700 W a
#: same-card copy fitted 17.9 TB/s on it and 1.57 TB/s on this one.
CUDA_TRANSFER_SIZES = tuple(1 << p for p in range(12, 29, 2))

#: Fraction of the raw measurement the dispatch-overhead correction may
#: not go below: keeps relative op ordering when the overhead is
#: comparable to the op cost itself.
CORRECTION_FLOOR_FRAC = 0.1


def corrected_seconds(seconds: float, overhead_s: float,
                      floor_frac: float = CORRECTION_FLOOR_FRAC) -> float:
    """Measured eager per-op seconds minus the per-call dispatch
    overhead, floored at ``floor_frac`` of the raw measurement: the one
    correction shared by the fitting (:mod:`.calibrate`) and annotation
    (``CalibrationProfile.op_seconds_by_signature``) paths."""
    return max(seconds - overhead_s, seconds * floor_frac)


def node_signature(name: str, flops: float, bytes_touched: float,
                   out_bytes: float) -> str:
    """Grouping key for "same op, same shape class": computable both
    while replaying the program (profiling) and from the bare cost graph
    (annotation), so measured times map back onto graph nodes. The
    reference tracer's per-iteration ``scan_slice_<it>`` names collapse
    to one signature, so a profile keyed by either package's graphs
    stays comparable."""
    if name.startswith("scan_slice_"):
        name = "scan_slice"
    return f"{name}|f={flops:.6g}|b={bytes_touched:.6g}|o={out_bytes:.6g}"


def graph_signatures(g) -> list[str]:
    """Per-node signatures of a traced cost graph (requires the tracer's
    ``op_flops``/``op_bytes`` annotations)."""
    if g.op_flops is None or g.op_bytes is None:
        raise ValueError(
            "cost graph carries no op_flops/op_bytes annotations: "
            "re-trace with repro_torch.api.trace to profile/annotate")
    mem = np.asarray(g.mem, dtype=np.float64)
    return [node_signature(g.names[i], float(g.op_flops[i]),
                           float(g.op_bytes[i]), float(mem[i]))
            for i in range(g.n)]


@dataclass
class OpSample:
    """One measured op signature."""
    signature: str
    name: str
    flops: float
    bytes_touched: float
    out_bytes: float            # live-memory delta of executing the op
    seconds: float              # robust per-call estimate
    dispersion: float
    count: int = 1              # program nodes this signature covers
    samples: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.float64))


@dataclass
class TransferSample:
    nbytes: float
    seconds: float
    dispersion: float
    samples: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.float64))


def _nbytes(v) -> float:
    if isinstance(v, torch.Tensor):
        return float(v.numel() * v.element_size())
    if isinstance(v, (tuple, list)):
        return float(sum(_nbytes(x) for x in v))
    return 0.0


def _writes_input(op) -> bool:
    schema = getattr(op, "_schema", None)
    return bool(schema is not None and schema.is_mutable)


def _time_node(prog, nid: int, invals: list, kwargs: dict,
               spec: MeasureSpec) -> Measurement:
    """Time one node's aten call; ``result`` is the value of one call on
    ``invals``. An op that writes an input runs in the timing loop on
    clones of its inputs (made once, outside the timed window), so the
    real inputs see exactly one call."""
    if not _writes_input(prog.program[nid][0]):
        return measure_call(lambda: run_node(prog, nid, invals, kwargs),
                            spec=spec, sync=synchronize)
    scratch = [v.clone() if isinstance(v, torch.Tensor) else v
               for v in invals]
    m = measure_call(lambda: run_node(prog, nid, scratch, kwargs),
                     spec=spec, sync=synchronize)
    m.result = synchronize(run_node(prog, nid, invals, kwargs))
    return m


def _replay(graph, prog, flat_args, device, spec: MeasureSpec,
            max_signatures: int | None) -> tuple[list[OpSample], Any]:
    """:func:`profile_ops`' replay; returns the samples and the program's
    outputs (the pytree the traced function returned)."""
    if len(flat_args) != len(prog.input_nodes):
        raise ValueError(f"expected {len(prog.input_nodes)} input leaves, "
                         f"got {len(flat_args)}")
    sigs = graph_signatures(graph)

    def place(v):
        return v.to(device) if isinstance(v, torch.Tensor) else v

    vals: dict[int, Any] = {}
    for nid, cval in prog.const_nodes:
        vals[nid] = place(cval)
    for nid, a in zip(prog.input_nodes, flat_args):
        vals[nid] = place(a)

    def read(src: int, idx: int):
        v = vals[src]
        return v[idx] if isinstance(v, (tuple, list)) else v

    # the signatures to time: those of nodes that do work (a view has
    # no FLOPs and no bytes); the budget counts their populations first,
    # so the cap keeps the *hottest* signatures, not the first-encountered
    pop: dict[str, int] = {}
    for nid in prog.program:
        if graph.op_flops[nid] > 0 or graph.op_bytes[nid] > 0:
            pop[sigs[nid]] = pop.get(sigs[nid], 0) + 1
    allowed: set[str] | None = None
    if max_signatures is not None and len(pop) > max_signatures:
        flop_of = {s: 0.0 for s in pop}
        for nid in prog.program:
            if sigs[nid] in flop_of:
                flop_of[sigs[nid]] = float(graph.op_flops[nid])
        ranked = sorted(pop, key=lambda s: (pop[s] * (1.0 + flop_of[s])),
                        reverse=True)
        allowed = set(ranked[:max_signatures])

    # liveness-driven freeing: drop a producer's value once its last
    # consumer has run (graph outputs stay), as the segment runtime does
    consumers, output_nodes = prog.liveness()
    remaining = {p: len(cs) for p, cs in consumers.items()}

    samples: dict[str, OpSample] = {}
    for nid in sorted(prog.program):
        _, node_kw, inputs = prog.program[nid]
        invals = [inp[1] if inp[0] == "lit" else read(inp[1], inp[2])
                  for inp in inputs]
        kwargs = node_kwargs(node_kw, device)
        sig = sigs[nid]
        rec = samples.get(sig)
        if rec is not None or sig not in pop or \
                (allowed is not None and sig not in allowed):
            if rec is not None:
                rec.count += 1
            vals[nid] = run_node(prog, nid, invals, kwargs)
        else:
            m = _time_node(prog, nid, invals, kwargs, spec)
            vals[nid] = m.result
            samples[sig] = OpSample(
                signature=sig, name=graph.names[nid],
                flops=float(graph.op_flops[nid]),
                bytes_touched=float(graph.op_bytes[nid]),
                out_bytes=_nbytes(m.result),
                seconds=m.seconds, dispersion=m.dispersion,
                samples=np.asarray(m.samples, dtype=np.float64))
        del invals
        for src in {inp[1] for inp in inputs if inp[0] != "lit"}:
            remaining[src] -= 1
            if remaining[src] == 0 and src not in output_nodes:
                vals.pop(src, None)
    outs = [None if slot is None else read(*slot) for slot in prog.out_slots]
    return list(samples.values()), tree_unflatten(prog.out_tree, outs)


def profile_ops(graph, prog, *flat_args, device=None,
                spec: MeasureSpec = DEFAULT_SPEC,
                max_signatures: int | None = None) -> list[OpSample]:
    """Replay ``prog`` op by op, timing one representative node per
    signature.

    Args:
        graph: the traced :class:`CostGraph` (node ids match ``prog``;
            provides names/flops/bytes for the signatures).
        prog: recorded :class:`TracedProgram`.
        flat_args: flattened input leaves, in ``prog.input_nodes`` order
            (``repro_torch.tree.tree_flatten(example)[0]``); concrete
            tensors, moved to ``device``.
        device: the torch device everything runs on (``None``: ``cuda``,
            which raises on a machine without one).
        spec: robust-timing knobs.
        max_signatures: measurement budget: signatures beyond it (in
            descending node-count x FLOPs order) are replayed but not
            timed.

    Returns one :class:`OpSample` per *measured* signature, ``count``
    set to the number of program nodes the signature covers. Views (no
    FLOPs, no bytes) are replayed, not timed.
    """
    return _replay(graph, prog, flat_args, resolve_device(device), spec,
                   max_signatures)[0]


def measure_dispatch_overhead(device=None,
                              spec: MeasureSpec = DEFAULT_SPEC
                              ) -> Measurement:
    """Per-call eager overhead: the seconds of the cheapest possible op
    (a one-element add) timed as every op is timed, host clock around
    the call and the wait for the device.

    Op-by-op replay pays this on *every* call, but a segment replayed as
    a CUDA graph does not: measured op costs are corrected by it before
    they predict segment times (``TracedModel.annotate`` does)."""
    device = resolve_device(device)
    x = torch.ones(1, dtype=torch.float32, device=device)
    y = torch.full((1,), 2.0, dtype=torch.float32, device=device)
    synchronize((x, y))
    return measure_call(lambda: torch.add(x, y), spec=spec,
                        sync=synchronize)


def transfer_pair(src=None, dst=None) -> tuple[torch.device, torch.device]:
    """The (source, destination) devices :func:`profile_transfers` times
    by default: ``src`` (``None``: ``cuda``, which raises without one),
    and the next card when there are two or more, else ``src`` itself."""
    def indexed(d):
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        return d
    src = indexed(src)
    if dst is None:
        n = torch.cuda.device_count() if src.type == "cuda" else 1
        dst = torch.device("cuda", (src.index + 1) % n) if n > 1 else src
    return src, indexed(dst)


def transfer_probe(src, dst) -> str:
    """What :func:`profile_transfers` measures between ``src`` and
    ``dst``, for the profile's ``meta``."""
    src, dst = torch.device(src), torch.device(dst)
    if src != dst:
        return f"peer copy {src} -> {dst}"
    if src.type == "cuda":
        return f"device-to-device copy on {src}"
    return f"host copy on {src}"


def default_transfer_sizes(src) -> tuple[int, ...]:
    """The ladder :func:`profile_transfers` times from ``src`` by default:
    :data:`CUDA_TRANSFER_SIZES` from a card, else
    :data:`DEFAULT_TRANSFER_SIZES`."""
    return (CUDA_TRANSFER_SIZES if torch.device(src).type == "cuda"
            else DEFAULT_TRANSFER_SIZES)


def profile_transfers(sizes=None, *, src=None, dst=None,
                      spec: MeasureSpec = DEFAULT_SPEC
                      ) -> list[TransferSample]:
    """Time one copy of ``n`` float32 bytes from ``src`` into a buffer on
    ``dst`` (defaults: :func:`transfer_pair`) over a ladder of sizes
    (default: :func:`default_transfer_sizes`): a peer copy between two
    cards, a device-to-device copy on one card, a host copy on the CPU;
    the copy the segment runtime issues, into a buffer made
    beforehand."""
    src, dst = transfer_pair(src, dst)
    if sizes is None:
        sizes = default_transfer_sizes(src)
    out = []
    for nbytes in sizes:
        n = max(int(nbytes) // 4, 1)
        payload = torch.zeros(n, dtype=torch.float32, device=src)
        buf = torch.empty(n, dtype=torch.float32, device=dst)
        synchronize((payload, buf))
        m = measure_call(lambda: buf.copy_(payload, non_blocking=True),
                         spec=spec,
                         sync=lambda r: synchronize((r, payload)))
        out.append(TransferSample(
            nbytes=float(n * 4), seconds=m.seconds,
            dispersion=m.dispersion,
            samples=np.asarray(m.samples, dtype=np.float64)))
    return out


def profile_segments(runtime, *args, reps: int = 3, warmup: bool = True,
                     **kwargs) -> dict:
    """Measured per-segment seconds of a compiled runtime.

    Enables the runtime's per-segment profiling mode (segments
    serialised; on the card, timing events around each graph replay),
    runs ``reps`` full calls, and reduces each segment's samples to a
    median + MAD. Pass ``warmup=False`` when the runtime has already run
    (capture paid) to skip the unrecorded warmup pass.

    Returns ``{"seconds": np.ndarray[num_segments],
    "dispersion": np.ndarray, "samples": np.ndarray[reps, S],
    "wall_seconds": np.ndarray[reps]}``.
    """
    if warmup:
        runtime(*args, **kwargs)      # pays capture
    rows, walls = [], []
    prev = runtime.profile_segments
    runtime.profile_segments = True
    try:
        for _ in range(max(int(reps), 1)):
            runtime(*args, **kwargs)
            rows.append(list(runtime.stats.segment_seconds))
            walls.append(runtime.stats.execute_seconds)
    finally:
        runtime.profile_segments = prev
    mat = np.asarray(rows, dtype=np.float64)
    med = np.median(mat, axis=0)
    mad = np.median(np.abs(mat - med[None, :]), axis=0)
    disp = np.divide(mad, med, out=np.zeros_like(med), where=med > 0)
    return {"seconds": med, "dispersion": disp, "samples": mat,
            "wall_seconds": np.asarray(walls, dtype=np.float64)}


__all__ = ["CORRECTION_FLOOR_FRAC", "CUDA_TRANSFER_SIZES",
           "DEFAULT_TRANSFER_SIZES", "OpSample", "TransferSample",
           "corrected_seconds", "default_transfer_sizes", "graph_signatures",
           "measure_dispatch_overhead", "node_signature",
           "profile_ops", "profile_segments", "profile_transfers",
           "transfer_pair", "transfer_probe"]
