"""Dry run on one H100 (port of ``repro.launch.dryrun``): prove every
(architecture x input shape) cell traces at its full config and the
shape's full global batch, and price it.

Per cell it records into ``results/dryrun_torch/<cell>.json``:

  * the step traced by ``api.trace`` on fake tensors of
    ``models.io_spec``'s shapes, so nothing is allocated: train cells the
    loss and its gradient under ``--remat``, prefill cells
    ``train.build_prefill_step``, decode cells ``train.build_serve_step``;
  * ``graph_flops`` and ``graph_bytes``, summed over the cost graph's
    nodes (the reference's ``hlo_flops`` and ``hlo_bytes``; the port's
    trace is flat, so no unroll-1 / unroll-2 extrapolation is needed);
  * ``per_device_total_bytes``: the bytes live at the peak of the step
    run on one card in the order the trace recorded it, which is the
    order the eager step runs (:func:`trace_order_peak`), and ``fits``
    against the card's 80 GiB on it; ``emulated_peak_bytes`` beside it,
    the one-PE peak that ParDNN's emulator prices (its list order runs a
    recompute as soon as its inputs exist, so remat does not lower it);
  * the three roofline terms and the dominant one, on the H100's
    constants (``core.costmodel``), and ``model_flops`` (the reference's
    formula).

``--mesh multi`` train cells trace one rank's program instead: rank 0
of ``make_production_mesh(multi_pod=True)`` (pod 2, data 16, model 16;
512 chips) over a :class:`~repro_torch.distributed.TracingMesh`, on fake
tensors of that rank's shapes (its blocks of the parameters, its
``global_batch / 32`` rows): the tensor-parallel loss and gradient, the
gradient's reduction over the batch axes and the parameters' gather
after the update (AdamW's own arithmetic left out, as the single cells
leave it out), with every collective a node of the graph.
:func:`collective_bytes_from_graph` counts them by the reference's
kinds, the counterpart of ``collective_bytes_from_hlo``; the record's
``collective_bytes`` and the roofline's collective term (the H100's
NVLink rate) come from it, and ``per_device_total_bytes`` and ``fits``
are the rank's. The numbers are not the reference's: its HLO moves
GSPMD's sequence-parallel all-gathers and reduce-scatters around each
block (the plan's ``btd`` over ``model``), where the port runs Megatron's
all-reduces (one forward and one backward a block's attention, MLA,
RWKV mix, Mamba mixer or MLP, and again in a recompute; Mamba's
``w_x`` product psummed both ways). Multi prefill and decode cells trace
rank 0's prefill or serve step over the same mesh
(:func:`trace_rank_serve`): its blocks of the parameters and of the
caches (``rules.serve_cache_specs``), its rows, and at ``long_500k``
(batch 1, below the 32 data-parallel ways) the whole batch with the
caches' sequence cut over ``data``; a multi cell runs wherever its
single cell runs.

It differs from the reference where the card differs: no ``XLA_FLAGS``
line and no forced device count; the results go to
``results/dryrun_torch`` (the reference writes ``results/dryrun``, with
the same cell names, and each would read the other's files as
``[cached]``); on one card ``collective_bytes`` is 0.

Usage:
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --pardnn --arch gemma3-1b \\
      --pardnn-devices 4                       # emit PartitionPlan files
  python -m repro_torch.launch.dryrun --calibrate --arch repro-lm-100m \\
      --pardnn-devices 4   # profile ops/links, fit + save a
                           # CalibrationProfile, report stage MAPE
Flags for perf iterations: --remat, --tag (variant label kept in the
result file name so baselines are never overwritten). ``--device``
(default ``cuda``; ``cpu`` on a machine without a card) is where the
cells trace their fake tensors and where ``--pardnn`` and
``--calibrate`` run.

``--pardnn`` goes through the ``repro_torch.api`` facade: it traces each
arch's reduced loss, partitions it, and writes the versioned plan
artifact next to the dry-run results; on one card the K PEs fold onto it
(``api.fold_device_map``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from .. import resolve_device
from ..configs import ASSIGNED_ARCHS, SHAPES, get_config, shape_skip_reason
from ..core.costmodel import (H100_HBM_BW, H100_HBM_BYTES, H100_NVLINK_BW,
                              H100_PEAK_FLOPS)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes_from_graph(graph) -> dict:
    """The collectives of a traced rank's program (the nodes of
    ``core.tracing.COLLECTIVE_OPS``), by the reference's kinds: each
    one's operand bytes (what it touches less its result), summed, and
    counted (``{"bytes", "counts", "total_bytes"}``, the counterpart of
    the reference's ``collective_bytes_from_hlo``)."""
    from ..core.tracing import COLLECTIVE_OPS
    out = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for name, touched, mem in zip(graph.names, graph.op_bytes, graph.mem):
        kind = COLLECTIVE_OPS.get(name)
        if kind is not None:
            out[kind] += float(touched - mem)
            counts[kind] += 1
    return {"bytes": out, "counts": counts,
            "total_bytes": float(sum(out.values()))}


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int) -> dict:
    t_c = flops / (chips * H100_PEAK_FLOPS)
    t_m = hbm_bytes / (chips * H100_HBM_BW)
    t_x = coll_bytes / (chips * H100_NVLINK_BW)
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dom[1], "bound_s": dom[0]}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode D=batch
    tokens; train includes the 3x backward factor already (6 = 2 fwd + 4
    bwd per param per token)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/slot


def _loss_and_grad(cfg, remat: str):
    """``step(params, batch) -> (loss, grads)``: the loss and its
    gradient over the per-layer leaves, as the train steps take it."""
    from ..models import unstack_periods
    from ..train.step import loss_and_grads

    def step(params, batch):
        loss, _, grads = loss_and_grads(cfg, unstack_periods(cfg, params),
                                        batch, remat)
        return loss, grads

    return step


def _fake_on(tree, dev: torch.device):
    """The meta tensors of ``tree`` as fake tensors on ``dev``, all of
    one fake mode: shapes, strides and dtypes, no storage. The kernel
    wrappers take cuda or cpu tensors, not meta ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..tree import tree_map
    with FakeTensorMode():
        return tree_map(lambda t: torch.empty_strided(
            t.shape, t.stride(), dtype=t.dtype, device=dev), tree)


def _trace_cell(cfg, shape, remat: str, dev: torch.device):
    """The cell's step traced on fake tensors on ``dev`` (nothing is
    allocated)."""
    from .. import api
    from ..models.io_spec import input_specs, params_spec
    from ..train.step import build_prefill_step, build_serve_step
    params, spec = _fake_on((params_spec(cfg), input_specs(cfg, shape)),
                            dev)
    if shape.kind == "train":
        return api.trace(_loss_and_grad(cfg, remat), params, spec["batch"],
                         autograd=True, record=True)
    if shape.kind == "prefill":
        return api.trace(build_prefill_step(cfg, shape.seq_len, dev),
                         params, spec["batch"], record=True)
    return api.trace(build_serve_step(cfg, shape, dev), params,
                     spec["caches"], spec["tokens"], spec["cache_pos"],
                     record=True)


def trace_rank_step(cfg, shape, remat: str, mesh, dev: torch.device):
    """The train step of one rank of ``mesh`` (a
    :class:`~repro_torch.distributed.TracingMesh`) traced on fake tensors
    on ``dev`` of that rank's shapes: its blocks of the parameters
    (``rules.param_specs``) and its ``global_batch / (pod x data)`` rows.
    The program: the tensor-parallel loss and gradient and the gradient's
    reduction (``train.step.grad_blocks``), then each block cast to the
    parameter's dtype and gathered over ``data``, as the update's
    parameters are (AdamW's arithmetic left out)."""
    from .. import api
    from ..models.io_spec import params_spec, train_batch_spec
    from ..sharding import rules
    from ..train.step import _placements, grad_blocks, rules_total_dp
    from ..tree import tree_flatten, tree_map
    n_dp = rules_total_dp(mesh)
    if shape.global_batch % n_dp:
        raise ValueError(f"{shape.name}: a global batch of "
                         f"{shape.global_batch} does not split over "
                         f"{n_dp} data-parallel ranks")
    whole = params_spec(cfg)
    local = tree_map(lambda p, sh: torch.empty(
        sh.shard_shape(p.shape), dtype=p.dtype, device=p.device), whole,
        rules.param_shardings(whole, mesh))
    params, batch = _fake_on((local, train_batch_spec(
        cfg, shape.global_batch // n_dp, shape.seq_len)), dev)
    placement = _placements(cfg, mesh)
    plan = rules.activation_plan(mesh, cfg, kind="train")

    def step(params, batch):
        loss, _, blocks, gnorm = grad_blocks(cfg, mesh, plan, placement,
                                             params, batch, remat)
        with torch.no_grad():
            new = [sh.gather(b.to(p.dtype)) for p, b, (_, sh) in zip(
                tree_flatten(params)[0], blocks, placement)]
        return loss, gnorm, new

    return api.trace(step, params, batch, autograd=True, record=True)


def trace_rank_serve(cfg, shape, mesh, dev: torch.device):
    """The prefill or serve step (``shape``'s kind) of one rank of
    ``mesh`` (a :class:`~repro_torch.distributed.TracingMesh`) traced on
    fake tensors on ``dev`` of that rank's shapes: its blocks of the
    parameters, its rows of the batch or tokens (``global_batch / (pod x
    data)``; the whole batch at long context, where it is smaller than
    that), and for decode its blocks of the caches
    (``train.step.cache_shardings``) and a 0-d ``cache_pos``."""
    from .. import api
    from ..models.io_spec import (cache_spec, decode_token_spec,
                                  params_spec, prefill_batch_spec)
    from ..sharding import rules
    from ..train.step import (_rows, build_prefill_step, build_serve_step,
                              cache_shardings, rules_total_dp)
    from ..tree import tree_map
    long_context = shape.kind == "decode" and \
        shape.global_batch < rules_total_dp(mesh)
    rows = shape.global_batch if long_context else \
        _rows(shape.global_batch, mesh)

    def local(whole, shs):
        return tree_map(lambda p, sh: torch.empty(
            sh.shard_shape(p.shape), dtype=p.dtype, device=p.device), whole,
            shs)
    p_whole = params_spec(cfg)
    params = local(p_whole, rules.param_shardings(p_whole, mesh))
    if shape.kind == "prefill":
        params, batch = _fake_on((params, prefill_batch_spec(
            cfg, rows, shape.seq_len)), dev)
        return api.trace(build_prefill_step(cfg, shape.seq_len, dev, mesh),
                         params, batch, record=True)
    c_whole = cache_spec(cfg, shape.global_batch, shape.seq_len)
    caches = local(c_whole, cache_shardings(c_whole, mesh, long_context))
    params, caches, tokens, pos = _fake_on(
        (params, caches, decode_token_spec(cfg, rows),
         torch.empty((), dtype=torch.int32, device="meta")), dev)
    return api.trace(build_serve_step(cfg, shape, dev, mesh), params,
                     caches, tokens, pos, record=True)


def trace_order_peak(traced) -> float:
    """Bytes live at the peak of the traced step run on one device in
    the order the trace recorded its nodes, the order the eager step
    runs them: the inputs and constants throughout, each node's outputs
    from the node until the last node that reads them or a view of them,
    and the step's outputs to the end. A view allocates nothing and
    keeps its base alive. Needs the recorded program (``record=True``)."""
    from ..core.tracing import VIEW_OPS
    prog = traced.program
    mem = np.asarray(traced.graph.mem, dtype=np.float64)
    consumers, outputs = prog.liveness()
    roots = set(prog.input_nodes) | {nid for nid, _ in prog.const_nodes}
    live = float(sum(mem[nid] for nid in roots))
    nodes = sorted(prog.program)
    base: dict[int, int] = {}
    last: dict[int, float] = {}
    for nid in nodes:
        op, _, inputs = prog.program[nid]
        src = next((i[1] for i in inputs if i[0] == "slot"), None)
        is_view = op.overloadpacket.__name__ in VIEW_OPS
        b = base.get(src, src) if is_view and src is not None else nid
        base[nid] = b
        end = (np.inf if nid in outputs
               else max(consumers.get(nid, ()), default=nid))
        last[b] = max(last.get(b, nid), end)
    frees: dict[float, list[int]] = {}
    for b, end in last.items():
        if b not in roots:
            frees.setdefault(end, []).append(b)
    peak = live
    for nid in nodes:
        if base[nid] == nid:
            live += mem[nid]
            peak = max(peak, live)
        for b in frees.get(nid, ()):
            live -= mem[b]
    return float(peak)


def one_pe_peak(graph) -> float:
    """Bytes ParDNN's emulator prices for the graph with every node on
    PE 0 (its list order, not the trace's)."""
    from ..core.emulator import emulate
    from ..core.memops import compute_profile
    zero = np.zeros(graph.n, dtype=np.int64)
    return float(compute_profile(graph, zero, emulate(graph, zero, 1),
                                 1).peak[0])


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             remat: str = "dots", tag: str = "", device=None) -> dict:
    """One dry-run cell, traced on fake tensors on ``device`` (``None``:
    cuda, which raises where there is none): nothing is allocated.
    ``mesh_kind="single"``: the step on one H100; ``"multi"``: rank 0's
    program on the 512-chip production mesh (:func:`trace_rank_step` for
    train cells, :func:`trace_rank_serve` for prefill and decode). The
    record keeps the reference's keys where they mean the same
    (``status``, ``chips``, ``remat``, ``tag``, ``roofline``,
    ``model_flops``, ``useful_flops_ratio``, ``collective_bytes``,
    ``collective_bytes_by_op`` and ``collective_schedule``; on the multi
    mesh the FLOPs, bytes and collective bytes are the rank's times the
    chips, as the reference's are per device times chips, and
    ``rank_collective_bytes`` is the rank's own by kind);
    ``per_device_total_bytes`` is the one-card (or the rank's) peak in
    the trace's order (:func:`trace_order_peak`) where the reference
    reads XLA's buffer assignment, and ``fits`` is judged on it;
    ``emulated_peak_bytes`` is the emulator's one-PE peak
    (:func:`one_pe_peak`); ``trace_s`` stands for ``lower_s`` and
    ``compile_s``, ``graph_flops`` and ``graph_bytes`` for ``hlo_flops``
    and ``hlo_bytes``."""
    from ..distributed import TracingMesh
    from .mesh import make_production_mesh, mesh_num_chips
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    skip = shape_skip_reason(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "SKIP", "reason": skip}
    dev = resolve_device(device)
    chips = 1
    t0 = time.perf_counter()
    if multi:
        shape_m = make_production_mesh(multi_pod=True)
        chips = mesh_num_chips(shape_m)
        mesh = TracingMesh(shape_m, 0, dev)
        traced = trace_rank_step(cfg, shape, remat, mesh, dev) \
            if shape.kind == "train" else \
            trace_rank_serve(cfg, shape, mesh, dev)
    else:
        traced = _trace_cell(cfg, shape, remat, dev)
    trace_s = time.perf_counter() - t0
    g = traced.graph
    flops = float(np.sum(g.op_flops)) * chips
    nbytes = float(np.sum(g.op_bytes)) * chips
    coll = collective_bytes_from_graph(g)
    coll_bytes = coll["total_bytes"] * chips
    peak = trace_order_peak(traced)
    mf = model_flops(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "OK", "tag": tag, "remat": remat, "chips": chips,
        "trace_s": round(trace_s, 2), "nodes": g.n,
        "graph_flops": flops, "graph_bytes": nbytes,
        "per_device_total_bytes": peak,
        "emulated_peak_bytes": one_pe_peak(g),
        "fits": bool(peak <= H100_HBM_BYTES),
        "collective_bytes": coll_bytes,
        "roofline": roofline_terms(flops, nbytes, coll_bytes, chips),
        "model_flops": mf,
        "useful_flops_ratio": mf / flops if flops else None,
    }
    if multi:
        rec.update(collective_schedule=coll["counts"],
                   collective_bytes_by_op={k: v * chips for k, v in
                                           coll["bytes"].items()},
                   rank_collective_bytes=coll["bytes"])
    return rec


def reduced_loss_trace(arch: str, device=None, record: bool = True):
    """``(params, traced)``: the parameters of the arch's reduced config
    from seed 0 on ``device`` (``None``: cuda) and the trace of its loss
    on the smoke batch (the graph ``--pardnn`` partitions, which
    ``python -m repro_torch.analysis --arch`` rebuilds to bind a saved
    plan)."""
    from .. import api
    from ..configs import reduced
    from ..models import init_params, loss_fn, smoke_batch
    dev = resolve_device(device)
    cfg = reduced(get_config(arch))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    batch = smoke_batch(cfg, device=dev)
    traced = api.trace(lambda p: loss_fn(cfg, p, batch)[0], params,
                       record=record)
    return params, traced


def _placement(devices: int, dev: torch.device):
    """(devices, device_map) that fold ``devices`` PEs onto ``dev``'s
    kind: the CPU, or every visible card."""
    from .. import api
    devs = [dev] if dev.type == "cpu" else None
    return devs, api.fold_device_map(devices, devs)


def run_pardnn_plan(arch: str, devices: int, out_dir: str,
                    mem_cap_mb: float | None = None,
                    execute: bool = False, lint: bool = False,
                    trace: str | None = None, device=None) -> dict:
    """Trace the arch's reduced loss and emit a versioned
    :class:`repro_torch.api.PartitionPlan` artifact (JSON header + npz).

    With ``execute=True`` the placement is additionally *run* through
    both execution engines on ``device`` (``None``: cuda), its PEs folded
    onto the card (or the CPU): the op-by-op interpreter and the compiled
    segment runtime, and the result records the interpreter-vs-compiled
    speedup plus measured-vs-predicted peak bytes per PE.

    With ``lint=True`` the program is recorded even without execution so
    the full static verifier (``repro_torch.analysis``) can run, and the
    diagnostic report is written next to the plan. Either way
    ``plan.save`` refuses to write a plan carrying error-severity
    diagnostics: the caller sees the raise, not a silent artifact."""
    from .. import api
    dev = resolve_device(device)
    params, traced = reduced_loss_trace(arch, dev, record=execute or lint)
    plan = api.partition(
        traced, devices=devices,
        memory=mem_cap_mb * 1e6 if mem_cap_mb else None,
        meta={"arch": arch, "config": "reduced", "source": "dryrun"})
    path = os.path.join(out_dir, f"{arch}__pardnn_k{devices}.plan.json")
    res = {"arch": arch, "ops": plan.n, "path": path,
           "makespan_s": plan.makespan, "feasible": plan.feasible}
    vrep = plan.verify()
    res["diagnostics"] = vrep.summary_dict()
    res["verify_errors"] = len(vrep.errors)
    if lint:
        lpath = os.path.join(out_dir,
                             f"{arch}__pardnn_k{devices}.diagnostics.json")
        with open(lpath, "w") as f:
            json.dump(vrep.to_dict(), f, indent=1)
        res["diagnostics_path"] = lpath
    if execute:
        devs, device_map = _placement(devices, dev)
        res["runtime"] = plan.benchmark_runtimes(
            params, reps=1, devices=devs, device_map=device_map)
        plan.meta["runtime"] = res["runtime"]
        if trace:
            # one traced execution on top of the benchmark: merged
            # measured + predicted segment lanes (see repro_torch.obs)
            plan.execute(params, devices=devs, device_map=device_map,
                         trace=trace)
            res["trace_path"] = trace
    plan.save(path)
    return res


def run_calibration_cell(arch: str, devices: int, out_dir: str,
                         tiny: bool = False, device=None) -> dict:
    """Close the predict→execute loop for one arch on ``device``
    (``None``: cuda): profile the reduced loss's ops + copies, fit the
    device model, save the :class:`~repro_torch.profiling.
    CalibrationProfile` artifact next to the dry-run results,
    re-annotate, re-partition, and score the Step-2 emulator's per-stage
    predictions against the segment runtime's measured times
    (``PartitionPlan.accuracy_report``)."""
    from .. import api
    from ..configs import reduced
    from ..models import init_params, loss_fn, smoke_batch
    from ..profiling import MeasureSpec, quick_spec
    dev = resolve_device(device)
    cfg = reduced(get_config(arch))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    batch = smoke_batch(cfg, batch=2, seq=16 if tiny else 32, device=dev)
    traced = api.trace(lambda p: loss_fn(cfg, p, batch)[0], params,
                       record=True)
    ppath = os.path.join(out_dir, f"{arch}__calibration.json")
    spec = quick_spec(reps=2) if tiny else MeasureSpec()
    profile = api.calibrate(traced, spec=spec, device=dev,
                            max_signatures=40 if tiny else None,
                            meta={"arch": arch, "source": "dryrun"},
                            save=ppath)
    traced.annotate(profile)
    devs, device_map = _placement(devices, dev)
    plan = api.partition(traced, devices=devices,
                         meta={"arch": arch, "source": "dryrun",
                               "calibration": ppath})
    acc = plan.accuracy_report(params, devices=devs, device_map=device_map,
                               reps=2 if tiny else 3)
    return {"arch": arch, "ops": plan.n, "profile": ppath,
            "signatures": len(profile.ops), "fitted": profile.fitted,
            "stage_mape_pct": acc["stage_mape_pct"],
            "device_mape_pct": acc["device_mape_pct"],
            "measured_wall_s": acc["measured_wall_s"],
            "predicted_makespan_s": acc["predicted_makespan_s"],
            "summary": profile.summary()}


def cell_name(arch, shape, mesh_kind, tag=""):
    t = f"__{tag}" if tag else ""
    return f"{arch}__{shape}__{mesh_kind}{t}"


def _arch_path(path: str | None, arch: str, multi: bool) -> str | None:
    """Suffix the arch into ``path`` before the extension when one flag
    value has to fan out over several archs."""
    if path is None or not multi:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.{arch}{ext or '.json'}"


def _write_metrics(path: str, source: str, records: dict) -> None:
    from ..obs.metrics import wrap_metrics
    with open(path, "w") as f:
        json.dump(wrap_metrics(source, {"records": records}), f, indent=1)
    print(f"wrote metrics {path}", flush=True)


def _calibrate_main(args, dev) -> int:
    os.makedirs(args.out, exist_ok=True)
    archs = ASSIGNED_ARCHS if args.arch is None else [args.arch]
    records = {}
    for a in archs:
        t0 = time.perf_counter()
        try:
            res = run_calibration_cell(a, args.pardnn_devices, args.out,
                                       tiny=args.calibrate_tiny, device=dev)
            records[a] = res
            path = os.path.join(args.out, f"{a}__calibration_report.json")
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            mape = res["stage_mape_pct"]   # None: nothing scorable
            print(f"[OK] {a}: {res['summary']}; stage MAPE "
                  f"{'n/a' if mape is None else f'{mape:.1f}%'}, wall "
                  f"{res['measured_wall_s'] * 1e3:.1f} ms vs "
                  f"predicted {res['predicted_makespan_s'] * 1e3:.1f}"
                  f" ms -> {res['profile']} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        except Exception as e:
            records[a] = {"arch": a, "error": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {a}: {type(e).__name__}: {e}", flush=True)
    if args.metrics:
        _write_metrics(args.metrics, "dryrun_calibrate", records)
    return 0


def _print_runtime(rt: dict) -> None:
    mvp = " ".join(
        f"d{i}:{m / 1e6:.1f}/{p / 1e6:.1f}MB"
        for i, (m, p) in enumerate(zip(rt["measured_peak_bytes"],
                                       rt["predicted_peak_bytes"])))
    print(f"     runtime: {rt['num_segments']} segments, "
          f"{rt['transfers']} transfers, compiled "
          f"{rt['compiled_s'] * 1e3:.1f} ms vs interpreter "
          f"{rt['interpreter_s'] * 1e3:.0f} ms "
          f"({rt['speedup']:.0f}x); measured/predicted "
          f"peaks {mvp}", flush=True)
    print(f"     overlap: async {rt['compiled_s'] * 1e3:.1f} ms vs sync "
          f"{rt['compiled_sync_s'] * 1e3:.1f} ms "
          f"({rt['overlap_speedup']:.2f}x), "
          f"{rt['prefetched_transfers']}/{rt['transfers']} transfers "
          f"prefetched ({rt['deferred_transfers']} deferred), sync/async "
          f"drift {rt['sync_async_drift']:.3g}", flush=True)
    if rt["output_drift"] > 1e-5:
        print(f"     WARNING: output drift {rt['output_drift']:.3g}",
              flush=True)


def _pardnn_main(args, dev) -> int:
    os.makedirs(args.out, exist_ok=True)
    archs = ASSIGNED_ARCHS if args.arch is None else [args.arch]
    failed = 0
    records = {}
    multi = len(archs) > 1
    for a in archs:
        t0 = time.perf_counter()
        try:
            res = run_pardnn_plan(a, args.pardnn_devices, args.out,
                                  args.pardnn_mem_cap_mb,
                                  execute=args.pardnn_execute,
                                  lint=args.lint,
                                  trace=_arch_path(args.trace, a, multi),
                                  device=dev)
            records[a] = res
            dcounts = res["diagnostics"]["counts"]
            print(f"[OK] {a}: {res['ops']} ops, makespan "
                  f"{res['makespan_s'] * 1e3:.3f} ms, "
                  f"feasible={res['feasible']}, verified "
                  f"({dcounts['error']}E/{dcounts['warn']}W/"
                  f"{dcounts['info']}I) -> {res['path']} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
            if res.get("runtime"):
                _print_runtime(res["runtime"])
        except Exception as e:
            # includes PlanValidationError RP107: plan.save refuses
            # to write a plan with error-severity diagnostics
            records[a] = {"arch": a, "error": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {a}: {type(e).__name__}: {e}", flush=True)
            failed += 1
    if args.metrics:
        _write_metrics(args.metrics, "dryrun_pardnn", records)
    return 1 if failed else 0


def _cells_main(args, dev) -> int:
    cells = []
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ASSIGNED_ARCHS if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    for a in archs:
        for s in shapes:
            for m in meshes:
                cells.append((a, s, m))

    if args.list:
        for a, s, m in cells:
            skip = shape_skip_reason(get_config(a), SHAPES[s])
            print(f"{cell_name(a, s, m):60s} "
                  f"{'SKIP: ' + skip if skip else 'RUN'}")
        return 0

    os.makedirs(args.out, exist_ok=True)
    for a, s, m in cells:
        name = cell_name(a, s, m, args.tag)
        path = os.path.join(args.out, name + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[cached] {name}")
            continue
        print(f"[run] {name} ...", flush=True)
        t0 = time.perf_counter()
        try:
            res = run_cell(a, s, m, remat=args.remat, tag=args.tag,
                           device=dev)
        except Exception as e:
            res = {"arch": a, "shape": s, "mesh": m, "status": "FAIL",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        res["wall_s"] = round(time.perf_counter() - t0, 1)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        status = res["status"]
        extra = ""
        if status == "OK":
            r = res["roofline"]
            extra = (f"dom={r['dominant']} bound={r['bound_s']:.4f}s "
                     f"flops={res['graph_flops']:.3g} mem/dev="
                     f"{res['per_device_total_bytes'] / 2**30:.1f}G "
                     f"fits={res['fits']}")
        elif status == "FAIL":
            extra = res["error"][:200]
        print(f"[{status}] {name} ({res['wall_s']}s) {extra}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--pardnn", action="store_true",
                    help="emit PartitionPlan artifacts via the "
                         "repro_torch.api facade instead of the cells")
    ap.add_argument("--pardnn-devices", type=int, default=4)
    ap.add_argument("--pardnn-mem-cap-mb", type=float, default=None)
    ap.add_argument("--pardnn-execute", action="store_true",
                    help="also run the plan through both execution "
                         "engines and report interpreter-vs-compiled "
                         "speedup + measured-vs-predicted peak bytes")
    ap.add_argument("--lint", action="store_true",
                    help="with --pardnn: record the program so the full "
                         "static verifier runs, and write each plan's "
                         "diagnostic report next to its artifact")
    ap.add_argument("--calibrate", action="store_true",
                    help="profile real op/copy costs, fit the device "
                         "model, save a CalibrationProfile per arch and "
                         "report predicted-vs-measured stage MAPE")
    ap.add_argument("--calibrate-tiny", action="store_true",
                    help="cheap calibration settings (CI smoke)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="with --pardnn --pardnn-execute: write a "
                         "Perfetto trace (measured + predicted lanes) of "
                         "each plan's compiled execution; multi-arch runs "
                         "suffix the arch before the extension")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the per-arch result records as one "
                         "versioned repro-metrics envelope JSON")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.calibrate:
        return _calibrate_main(args, dev)
    if args.pardnn:
        return _pardnn_main(args, dev)
    return _cells_main(args, dev)


if __name__ == "__main__":
    raise SystemExit(main())
