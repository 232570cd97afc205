"""The training main path: per-arch specs, the train step, and the
full-loop runner with the invariants it asserts (the port's side of the
reference's ``repro/conformance/matrix.py``).

One :func:`run_conformance` call drives a single (reduced) architecture
through the complete ParDNN loop:

    cfg → init_params → random batch → train_step (autograd + SGD)
      → api.trace(record=True, autograd=True) → api.partition(K, memory)
      → plan.verify() → plan.execute(runtime="compiled"), async and sync
      → plan.execute(runtime="interpret")
      → the eager step (the un-partitioned truth)
      → plan.save / PartitionPlan.load / bind (round trip)

and checks, per arch, what the reference checks: compiled within a few
float ulp of the interpreter and within tolerance of the eager step;
async bit-equal to sync and compiled calls repeated bit-equal; every
node placed once in ``[0, K)``, the plan feasible and its peaks within
the cap; zero error-severity diagnostics; measured peaks within
``peak_factor x predicted + peak_slack``; the artifact round trip exact.
Checks never raise: every failure is an entry of the record's
``violations``.

The reference forces K host devices. The port runs its K PEs on K
devices when the process has them; on fewer (one card, or the CPU) it
folds them onto device 0 through ``device_map=[0] * K``, each PE keeping
its own stream, and the record says so (``device_map``, ``folded``). On
CUDA folding must be asked for (``fold=True``); the CPU has one device
and always folds.

:func:`run_serving_conformance` is the reference's serving scenario:
reduced granite-8b served through ``plan.serve`` at K=4 under a
block-starved pool and a shuffled admission order, token for token
against the sequential reference, with no leaked block and every pool
leaf on its PE's device.

Run one arch from the command line (``--trace PATH`` writes and holds a
Perfetto trace of the run)::

    PYTHONPATH=src python -m repro_torch.conformance --arch granite-8b \\
        --devices 4 --device cpu
    PYTHONPATH=src python -m repro_torch.conformance --arch granite-8b \\
        --serving --devices 4 --device cpu --trace /tmp/serving.json
    python -m repro_torch.conformance --arch granite-8b --serving \\
        --devices 4 --fold          # on one card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..tree import tree_flatten, tree_map, tree_unflatten

#: last-line marker the CLI prints before its JSON record (the
#: reference's ``subproc.JSON_MARK``)
JSON_MARK = "CONFORMANCE_JSON:"

#: per-arch overrides of the defaults in :class:`ArchSpec` (none: every
#: registered arch runs the full loop at the defaults)
MATRIX_OVERRIDES: dict[str, dict] = {}


@dataclass(frozen=True)
class ArchSpec:
    """How one architecture runs through the matrix, and its tolerances
    (the reference's defaults)."""
    arch: str
    periods: int = 2           # scanned periods
    batch: int = 2
    seq: int = 16
    devices: int = 4
    mem_cap: float = 2e9       # per-device Step-2 limit (generous: feasible)
    seed: int = 0
    lr: float = 1e-3
    # compiled vs interpreter: same ops, same order
    ci_rtol: float = 2e-5
    ci_atol: float = 2e-5
    # compiled vs the un-partitioned eager step
    ref_rtol: float = 2e-4
    ref_atol: float = 2e-4
    # measured peak live bytes vs the Step-2 prediction
    peak_factor: float = 4.0
    peak_slack: float = 8 * 2 ** 20


def build_matrix() -> dict[str, ArchSpec]:
    """One :class:`ArchSpec` per config the port registers."""
    from ..configs import REGISTRY
    return {name: ArchSpec(arch=name, **MATRIX_OVERRIDES.get(name, {}))
            for name in sorted(REGISTRY)}


def spec_for(arch: str, **overrides) -> ArchSpec:
    spec = build_matrix()[arch]
    return dataclasses.replace(spec, **overrides) if overrides else spec


# ---------------------------------------------------------------------------
# model-side builders
# ---------------------------------------------------------------------------
def reduced_config(spec: ArchSpec):
    from ..configs import get_config, reduced
    cfg0 = get_config(spec.arch)
    return reduced(cfg0, layers=len(cfg0.prelude)
                   + spec.periods * cfg0.period)


def example_batch(cfg, spec: ArchSpec, device=None) -> dict:
    """Random int32 targets of (spec.batch, spec.seq) in [0, vocab) and
    the inputs: int32 tokens of the same shape and range or, for a
    config with a stubbed frontend, float32 embeds (spec.batch,
    spec.seq, d_model) of standard normals times 0.1; drawn from a
    generator seeded with ``spec.seed`` on ``device``. The stream differs
    from the reference's ``jax.random``; the tests carry the reference's
    batch across as numpy instead."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(spec.seed)
    shape = (spec.batch, spec.seq)
    if cfg.frontend is not None:
        x = {"embeds": torch.randn((*shape, cfg.d_model), generator=g,
                                   device=dev) * 0.1}
    else:
        x = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                     device=dev, dtype=torch.int32)}
    targets = torch.randint(0, cfg.vocab_size, shape, generator=g,
                            device=dev, dtype=torch.int32)
    return {**x, "targets": targets}


def make_train_step(cfg, lr: float = 1e-3, *, return_grads: bool = False,
                    in_place: bool = False):
    """One SGD training step: ``train_step(params, batch) -> (loss,
    new_params)``, the reference's step. The gradient is taken by
    ``torch.autograd`` with the periods unbound
    (:func:`~repro_torch.models.unstack_periods`: every gradient leaf is
    one layer's tensor), the update is ``p - lr * g``, and each period
    leaf is restacked once, so ``new_params`` has ``params``' tree.

    ``return_grads=True`` also returns the gradients, with the periods
    as a list of per-period trees (no restacking copy). With bf16
    weights ``lr * g`` sits below one ulp of most ``p``, so new
    parameters alone would hide a wrong gradient.

    ``in_place=True`` writes each new leaf into ``params`` instead (the
    same values, bit for bit) and drops each gradient once used, so that
    the step holds the parameters and the gradients, not a third copy:
    ``train_step(params, batch) -> (loss, params)``. It does not trace
    (a traced step must not write its inputs).

    Trace the step with ``api.trace(..., autograd=True)``."""
    from ..models import loss_fn, unstack_periods

    def train_step(params, batch):
        unstacked = unstack_periods(cfg, params)
        leaves, structure = tree_flatten(unstacked)
        req = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            loss, _ = loss_fn(cfg, tree_unflatten(structure, req), batch)
            # a leaf the loss does not read (hubert's token embedding,
            # fed frame embeddings) gets zeros, as jax.grad gives it
            flat_grads = torch.autograd.grad(loss, req,
                                             materialize_grads=True)
        if in_place:
            flat_grads = list(flat_grads)
            with torch.no_grad():
                for i, p in enumerate(leaves):
                    p.sub_(lr * flat_grads[i])
                    flat_grads[i] = None
            return loss.detach(), params
        grads = tree_unflatten(structure, list(flat_grads))
        with torch.no_grad():
            new = tree_map(lambda p, g: p - lr * g,
                           {k: v for k, v in unstacked.items()
                            if k != "periods"},
                           {k: v for k, v in grads.items()
                            if k != "periods"})
            # each period leaf: L updates, stacked once
            L = len(unstacked["periods"])
            new["periods"] = tree_map(
                lambda *pg: torch.stack([p - lr * g for p, g in
                                         zip(pg[:L], pg[L:])]),
                *unstacked["periods"], *grads["periods"])
        out = (loss.detach(), new)
        return out + (grads,) if return_grads else out

    return train_step


# ---------------------------------------------------------------------------
# the full loop
# ---------------------------------------------------------------------------
def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.double() if t.is_floating_point() else t).cpu().numpy()


def _tree_max_diff(a, b) -> float:
    worst = 0.0
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        if x.numel():
            worst = max(worst, float(np.max(np.abs(_np(x) - _np(y)))))
    return worst


def _tree_close(a, b, rtol: float, atol: float) -> str | None:
    """None when every leaf matches dtype/shape and values within
    tolerance; else a description of the first mismatch."""
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    if len(la) != len(lb):
        return f"leaf count {len(la)} != {len(lb)}"
    for i, (x, y) in enumerate(zip(la, lb)):
        if x.shape != y.shape or x.dtype != y.dtype:
            return (f"leaf {i}: shape/dtype {tuple(x.shape)}/{x.dtype} != "
                    f"{tuple(y.shape)}/{y.dtype}")
        xn, yn = _np(x), _np(y)
        if not np.allclose(xn, yn, rtol=rtol, atol=atol):
            d = float(np.max(np.abs(xn - yn)))
            return f"leaf {i}: max abs diff {d:.3e} > rtol={rtol}/atol={atol}"
    return None


def _placement(arch: str, k: int, dev: torch.device, fold: bool):
    """(devices, device_map) the plan's ``k`` PEs run on."""
    if dev.type == "cpu":
        return ["cpu"], [0] * k
    n = torch.cuda.device_count()
    if n >= k:
        return [torch.device("cuda", i) for i in range(n)], None
    if not fold:
        raise RuntimeError(
            f"conformance for {arch} needs {k} devices, the process has "
            f"{n} CUDA devices: pass fold=True (--fold) to fold the PEs "
            f"onto them")
    return ([torch.device("cuda", i) for i in range(n)],
            [i % n for i in range(k)])


def run_conformance(spec: ArchSpec, save_dir: str | None = None,
                    trace_path: str | None = None, *, device=None,
                    fold: bool = False) -> dict:
    """Drive ``spec.arch`` through the full loop on ``device`` (``None``
    means ``cuda``); returns the conformance record (plain JSON types).

    ``trace_path`` additionally runs one traced compiled execution
    (``plan.execute(trace=...)``) and shape-validates the Perfetto
    document: an invalid trace, or one without both the measured and the
    predicted segment lanes, is a violation."""
    from .. import api
    from ..models import init_params

    violations: list[str] = []
    rec: dict = {"arch": spec.arch, "spec": {
        "periods": spec.periods, "batch": spec.batch, "seq": spec.seq,
        "devices": spec.devices, "mem_cap": spec.mem_cap,
        "peak_factor": spec.peak_factor, "peak_slack": spec.peak_slack}}

    dev = resolve_device(device)
    devices, device_map = _placement(spec.arch, spec.devices, dev, fold)
    rec["device"] = str(dev)
    rec["device_map"] = device_map
    rec["folded"] = device_map is not None
    cfg = reduced_config(spec)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        spec.seed), dev)
    batch = example_batch(cfg, spec, dev)
    train_step = make_train_step(cfg, lr=spec.lr)
    rec["num_layers"] = cfg.num_layers

    # --- un-partitioned reference: the eager step --------------------------
    ref = train_step(params, batch)

    # --- trace -------------------------------------------------------------
    t0 = time.perf_counter()
    traced = api.trace(train_step, params, batch, record=True,
                       autograd=True)
    rec["trace_s"] = time.perf_counter() - t0
    rec["num_nodes"] = traced.n

    # --- partition ---------------------------------------------------------
    t0 = time.perf_counter()
    plan = api.partition(traced, devices=spec.devices, memory=spec.mem_cap,
                         meta={"arch": spec.arch, "conformance": True,
                               "static_argnums": [0]})
    rec["partition_s"] = time.perf_counter() - t0
    rec["makespan_s"] = plan.makespan
    rec["feasible"] = bool(plan.feasible)
    rec["predicted_peak_bytes"] = [float(x) for x in plan.peak_mem]

    a = plan.assignment
    if a.shape[0] != traced.n:
        violations.append(
            f"assignment covers {a.shape[0]} nodes, graph has {traced.n}")
    if a.size and (int(a.min()) < 0 or int(a.max()) >= spec.devices):
        violations.append(
            f"assignment uses PEs [{int(a.min())}, {int(a.max())}] outside "
            f"[0, {spec.devices})")
    if not plan.feasible:
        violations.append("partition reported infeasible under "
                          f"mem_cap={spec.mem_cap:.3g}")
    for pe, peak in enumerate(plan.peak_mem):
        if plan.feasible and peak > spec.mem_cap:
            violations.append(
                f"device {pe}: predicted peak {peak:.3g} B exceeds the "
                f"limit {spec.mem_cap:.3g} B the partitioner was given")

    # --- static verification -----------------------------------------------
    t0 = time.perf_counter()
    vrep = plan.verify()
    rec["verify_s"] = time.perf_counter() - t0
    rec["diagnostics"] = vrep.summary_dict()
    for d in vrep.errors:
        violations.append(f"static verification: {d}")
    if vrep.has_errors():
        rec.update(violations=violations, ok=False)
        return rec

    def run(**kw):
        out = plan.execute(params, batch, devices=devices,
                           device_map=device_map, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    # --- compiled execution ------------------------------------------------
    t0 = time.perf_counter()
    out_c = run(runtime="compiled")
    rec["first_step_s"] = time.perf_counter() - t0
    rt = dict(plan.report.runtime)
    rec["compile_s"] = rt.get("compile_seconds", 0.0)
    rec["num_segments"] = rt.get("num_segments", 0)
    rec["segments_per_device"] = rt.get("segments_per_device", [])
    rec["cut_edges"] = rt.get("num_transfer_edges", 0)
    rec["transfers"] = rt.get("transfers", 0)
    rec["cut_edge_bytes"] = rt.get("transfer_bytes", 0.0)
    rec["measured_peak_bytes"] = rt.get("peak_live_bytes", [])
    rec["dispatch_mode"] = rt.get("mode", "")
    rec["prefetched_transfers"] = rt.get("prefetched_transfers", 0)
    rec["deferred_transfers"] = rt.get("deferred_transfers", 0)
    rec["peak_inflight_transfer_bytes"] = rt.get(
        "peak_inflight_transfer_bytes", 0.0)

    t0 = time.perf_counter()
    out_c2 = run(runtime="compiled")
    rec["step_s"] = time.perf_counter() - t0
    det = _tree_max_diff(out_c, out_c2)
    if det != 0.0:
        violations.append(
            f"compiled runtime not deterministic across calls "
            f"(max abs diff {det:.3e})")

    # --- traced execution: merged measured + predicted lanes ---------------
    if trace_path is not None:
        from ..obs.trace import (load_trace, predicted_vs_measured,
                                 validate_trace)
        run(runtime="compiled", trace=trace_path)
        doc = load_trace(trace_path)
        rec["trace_path"] = trace_path
        rec["trace_events"] = len(doc.get("traceEvents", []))
        for p in validate_trace(doc):
            violations.append(f"trace: {p}")
        pvm = predicted_vs_measured(doc)
        rec["trace_segments_matched"] = len(pvm)
        if not pvm:
            violations.append(
                "trace: no segment present in both the predicted and "
                "measured lanes")

    # --- dispatch-mode equality: sync == async, exactly --------------------
    t0 = time.perf_counter()
    out_s = run(runtime="compiled", mode="sync")
    rec["sync_step_s"] = time.perf_counter() - t0
    sync_drift = _tree_max_diff(out_c, out_s)
    rec["sync_async_max_diff"] = sync_drift
    if sync_drift != 0.0:
        violations.append(
            f"sync dispatch != async dispatch "
            f"(max abs diff {sync_drift:.3e})")

    # --- interpreter equality ----------------------------------------------
    out_i = run(runtime="interpret")
    rec["compiled_vs_interpreter_max_diff"] = _tree_max_diff(out_c, out_i)
    msg = _tree_close(out_c, out_i, spec.ci_rtol, spec.ci_atol)
    if msg:
        violations.append(f"compiled != interpreter: {msg}")

    # --- reference equality ------------------------------------------------
    rec["compiled_vs_reference_max_diff"] = _tree_max_diff(out_c, ref)
    msg = _tree_close(out_c, ref, spec.ref_rtol, spec.ref_atol)
    if msg:
        violations.append(f"compiled != un-partitioned eager step: {msg}")
    loss = float(out_c[0])
    rec["loss"] = loss
    if not np.isfinite(loss):
        violations.append(f"non-finite loss {loss}")

    # --- measured peak vs Step-2 prediction --------------------------------
    pred = rec["predicted_peak_bytes"]
    meas = rec["measured_peak_bytes"]
    rec["peak_ratio"] = [(m / p if p else None) for m, p in zip(meas, pred)]
    for pe, (m, p) in enumerate(zip(meas, pred)):
        if m > p * spec.peak_factor + spec.peak_slack:
            violations.append(
                f"device {pe}: measured peak {m:.3g} B exceeds "
                f"{spec.peak_factor}x predicted ({p:.3g} B) + "
                f"{spec.peak_slack:.3g} B slack")

    # --- plan artifact round trip ------------------------------------------
    with tempfile.TemporaryDirectory() as td:
        path = plan.save((save_dir or td) + f"/{spec.arch}.plan.json")
        plan2 = api.PartitionPlan.load(path, traced=traced)
        if not np.array_equal(plan2.assignment, plan.assignment):
            violations.append("plan round-trip changed the assignment")
        if plan2.fingerprint != plan.fingerprint:
            violations.append("plan round-trip changed the fingerprint")
        if plan2.k != plan.k:
            violations.append("plan round-trip changed K")
        if plan2.meta.get("static_argnums") != [0]:
            violations.append("plan round-trip lost static_argnums")

    rec["violations"] = violations
    rec["ok"] = not violations
    return rec


# ---------------------------------------------------------------------------
# serving scenario
# ---------------------------------------------------------------------------
#: the scenario's block-starved pool (the reference's): 4 requests of up
#: to 18 tokens (72 in all) against 9 allocatable blocks of 4 (36 tokens)
#: force preemption
SERVING_GEOMETRY = dict(block_size=4, num_blocks=10, max_batch=4,
                        max_len=20)
SERVING_REQUESTS = 4
SERVING_NEW_TOKENS = 10
#: cache length of the sequential reference
SERVING_REFERENCE_LEN = 32


def serving_prompts(cfg, rng: np.random.Generator) -> list[np.ndarray]:
    """The scenario's prompts, drawn as the reference draws them: 3-8
    int32 tokens each in [1, vocab)."""
    return [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 9, size=SERVING_REQUESTS)]


@torch.no_grad()
def sequential_tokens(cfg, params, prompt: np.ndarray, max_new: int,
                      device=None) -> tuple[list[int], list[float]]:
    """The un-partitioned sequential reference of one request: ``prefill``
    into caches of :data:`SERVING_REFERENCE_LEN`, then greedy
    ``decode_step`` calls, one token each. Returns the tokens and, for
    each, its top-1 / top-2 logit gap."""
    from ..models import decode_step, prefill
    dev = resolve_device(device)
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=dev)[None]
    logits, caches = prefill(cfg, params, {"tokens": toks},
                             max_len=SERVING_REFERENCE_LEN)
    out: list[int] = []
    gaps: list[float] = []
    pos = toks.shape[1]
    while True:
        top = logits[0, -1].float().topk(2)
        out.append(int(top.indices[0]))
        gaps.append(float(top.values[0] - top.values[1]))
        if len(out) == max_new:
            return out, gaps
        logits, caches = decode_step(
            cfg, params, caches,
            torch.tensor([[out[-1]]], dtype=torch.int32, device=dev), pos)
        pos += 1


def _serving_trace_problems(path: str, n_req: int, preempted: int
                            ) -> list[str]:
    """What is wrong with a serving engine's trace: an invalid Perfetto
    document, a missing lane group (the engine lane, one lane per
    request), or an ``evicted`` instant count other than the
    preemptions."""
    from ..obs.trace import SERVING_PID, load_trace, validate_trace
    doc = load_trace(path)
    problems = list(validate_trace(doc))
    events = doc.get("traceEvents", [])
    lanes = sorted(e["args"]["name"] for e in events
                   if e.get("name") == "thread_name"
                   and e.get("pid") == SERVING_PID)
    want = sorted(["engine"] + [f"request {i}" for i in range(n_req)])
    if lanes != want:
        problems.append(f"serving lanes {lanes}, want {want}")
    evicted = sum(e.get("name") == "evicted" and e.get("ph") == "i"
                  and e.get("pid") == SERVING_PID for e in events)
    if evicted != preempted:
        problems.append(f"{evicted} evicted instants on the request lanes "
                        f"for {preempted} preemptions")
    return problems


def run_serving_conformance(arch: str = "granite-8b", devices: int = 4,
                            seed: int = 0, trace_path: str | None = None,
                            *, device=None, fold: bool = False) -> dict:
    """Serve a registered dense arch (reduced) through ``plan.serve`` at
    K=``devices`` on ``device`` (``None`` means ``cuda``) and check the
    reference's serving invariants:

      * **token equality**: plan-served continuous-batched greedy decode
        equals the un-partitioned sequential reference
        (:func:`sequential_tokens`) token for token per request, under
        (a) the block-starved pool of :data:`SERVING_GEOMETRY`, which
        forces eviction and resume, and (b) a shuffled admission order;
      * **zero leaked blocks** in both schedules;
      * **placement residency**: every pool leaf lies on the device of
        the PE the plan assigns its input node, a PE of the plan.

    The K PEs fold onto fewer devices as :func:`run_conformance` folds
    them (the CPU always; CUDA with ``fold``). ``trace_path``: schedule
    (a) writes the engine's Perfetto trace there; an invalid document, a
    missing lane group or an ``evicted`` count other than the
    preemptions is a violation. Checks never raise: each failure is an
    entry of ``violations``. Dense archs only,
    as in the reference: MoE capacity couples the rows of a batch."""
    from ..configs import get_config, reduced
    from ..kernels.flash_attention.ops import flash_attention
    from ..models import init_params
    from ..serving import Request, partition_for_serving

    violations: list[str] = []
    rec: dict = {"scenario": "serving", "arch": arch, "devices": devices}
    launched = (flash_attention.launches,
                dict(flash_attention.variant_launches))
    dev = resolve_device(device)
    devs, device_map = _placement(arch, devices, dev, fold)
    rec["device"] = str(dev)
    rec["device_map"] = device_map
    rec["folded"] = device_map is not None

    cfg = reduced(get_config(arch))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    rng = np.random.default_rng(seed)
    prompts = serving_prompts(cfg, rng)
    refs = [sequential_tokens(cfg, params, p, SERVING_NEW_TOKENS, dev)
            for p in prompts]
    rec["reference_min_gap"] = min(g for _, gaps in refs for g in gaps)
    refs = [toks for toks, _ in refs]

    t0 = time.perf_counter()
    plan = partition_for_serving(cfg, params, devices=devices, device=dev,
                                 **SERVING_GEOMETRY)
    rec["partition_s"] = time.perf_counter() - t0
    rec["num_nodes"] = plan.n
    rec["feasible"] = bool(plan.feasible)

    def serve_schedule(order, trace=None):
        eng = plan.serve(cfg, params, devices=devs, device_map=device_map,
                         trace=trace, device=dev)
        for i in order:
            eng.submit(Request(rid=int(i), prompt=prompts[i],
                               max_new_tokens=SERVING_NEW_TOKENS))
        return eng, eng.run_until_drained()

    def hold(name: str, eng, done) -> None:
        if eng.stats.leaked_blocks:
            violations.append(f"{name} schedule leaked "
                              f"{eng.stats.leaked_blocks} blocks")
        for i, ref in enumerate(refs):
            got = done[i].output if i in done else None
            if got != ref:
                violations.append(
                    f"{name} schedule: request {i} diverged from the "
                    f"sequential reference ({got} != {ref})")

    # (a) in-order admission, starved pool: forced eviction and resume
    t0 = time.perf_counter()
    eng_a, done_a = serve_schedule(range(SERVING_REQUESTS),
                                   trace=trace_path)
    rec["serve_s"] = time.perf_counter() - t0
    sa = eng_a.stats
    rec["evictions"] = sa.preempted
    rec["leaked_blocks_evict"] = sa.leaked_blocks
    rec["completed"] = sa.completed
    if trace_path is not None:
        rec["trace_path"] = trace_path
        violations += [f"trace: {p}" for p in _serving_trace_problems(
            trace_path, SERVING_REQUESTS, sa.preempted)]
    if sa.preempted == 0:
        violations.append("starved schedule forced no eviction: the "
                          "scenario is not exercising preemption")
    hold("eviction", eng_a, done_a)

    # (b) shuffled admission order
    order = [int(i) for i in rng.permutation(SERVING_REQUESTS)]
    eng_b, done_b = serve_schedule(order)
    rec["admission_order"] = order
    rec["leaked_blocks_shuffled"] = eng_b.stats.leaked_blocks
    hold("shuffled", eng_b, done_b)
    for name, st in (("eviction", sa), ("shuffled", eng_b.stats)):
        if st.completed != SERVING_REQUESTS:
            violations.append(f"{name} schedule completed {st.completed} "
                              f"of {SERVING_REQUESTS} requests")

    # placement residency: each pool leaf on its PE's device
    pe_devs = plan._torch_devices(devs, device_map)
    n_params = len(tree_flatten(params)[0])
    prog = plan.traced.program
    leaves = tree_flatten(eng_b.pools)[0]
    want = [int(plan.assignment[prog.input_nodes[n_params + i]])
            for i in range(len(leaves))]
    rec["pool_pes"] = sorted(set(eng_b.pool_pes or []))
    rec["pool_devices"] = sorted({str(t.device) for t in leaves})
    if not leaves or eng_b.pool_pes is None:
        violations.append("plan-backed engine resolved no pool devices")
    elif eng_b.pool_pes != want:
        violations.append(f"pool leaves on PEs {eng_b.pool_pes}, the plan "
                          f"assigns {want}")
    else:
        for i, t in enumerate(leaves):
            if not 0 <= want[i] < plan.k or t.device != pe_devs[want[i]]:
                violations.append(
                    f"pool leaf {i} on {t.device}, outside PE {want[i]}'s "
                    f"device of the plan's {plan.k}")
                break

    # the flash kernels the scenario launched (its prefills; a CPU
    # tensor runs the plain version and launches none)
    rec["flash_launches"] = {
        "total": flash_attention.launches - launched[0],
        **{v: n - launched[1][v]
           for v, n in flash_attention.variant_launches.items()}}
    rec["serving_stats"] = plan.report.serving
    rec["violations"] = violations
    rec["ok"] = not violations
    return rec


def matrix_archs() -> list[str]:
    """The registered archs the matrix runs, sorted."""
    return sorted(build_matrix())


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Drive one arch's training step through trace -> "
                    "partition -> verify -> execute -> save/load.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--devices", type=int, default=4,
                    help="PEs of the plan (K)")
    ap.add_argument("--fold", action="store_true",
                    help="fold the K PEs onto fewer CUDA devices "
                         "(device_map); the CPU always folds")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers of the reduced config (whole periods)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--serving", action="store_true",
                    help="run the serving scenario (plan.serve token "
                         "equality and block accounting under a starved "
                         "pool and a shuffled order) instead of the "
                         "train-step loop")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Perfetto trace of the run (measured and "
                         "predicted segment lanes; request lanes with "
                         "--serving) and hold its validity")
    args = ap.parse_args(argv)
    if args.serving:
        rec = run_serving_conformance(arch=args.arch, devices=args.devices,
                                      trace_path=args.trace,
                                      device=args.device, fold=args.fold)
        print(JSON_MARK + json.dumps(rec))
        return 0 if rec["ok"] else 1
    from ..configs import get_config
    overrides: dict = {"devices": args.devices}
    if args.layers is not None:
        overrides["periods"] = max(args.layers // get_config(args.arch)
                                   .period, 1)
    for k in ("batch", "seq"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    rec = run_conformance(spec_for(args.arch, **overrides),
                          trace_path=args.trace, device=args.device,
                          fold=args.fold)
    print(JSON_MARK + json.dumps(rec))
    return 0 if rec["ok"] else 1


__all__ = ["ArchSpec", "JSON_MARK", "MATRIX_OVERRIDES", "SERVING_GEOMETRY",
           "build_matrix", "example_batch", "main", "make_train_step",
           "matrix_archs", "reduced_config", "run_conformance",
           "run_serving_conformance", "sequential_tokens",
           "serving_prompts", "spec_for"]


if __name__ == "__main__":
    raise SystemExit(main())
