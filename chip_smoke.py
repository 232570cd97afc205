#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--phases build,rwkv_kernels]

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and
``nvcc``. Phases, each of which fails the run if it fails:

1. card (always run): the card's name and power limit, as nvidia-smi
   reports them;
2. build: every CUDA kernel of the port (flash attention, RWKV6), from
   the sources in this checkout, into ``build/repro_torch_kernels/``,
   one nvcc per kernel, all started together;
3. kernels: flash attention against its plain PyTorch version at the
   reference's test shapes, at the granite-8b prefill shape (in float32
   as well) and at the edges of the bf16 Hopper kernel (``sm90``:
   ragged S, a cache with q_offset, window, soft cap, K/V views of a
   larger cache, hd 64 at the repro-lm-100m widths); every bf16 case
   also against the plain version run in float32, to one bf16 step. At
   the granite prefill shape the sm90 kernel, the first kernel
   (``fma``), the plain version and one PyTorch library call computing
   the same function are timed in turns (CUDA events around
   back-to-back calls, median of 3 turns) beside the roofline bound;
4. rwkv kernels: the RWKV6 recurrence against its plain version, y and
   the final state, at the reference's cases (zero and random state),
   a ragged length, the edges of the bf16 tensor-core kernel (``mma``:
   chunks of 32 and 16 with ragged tails, one token, r, k, v as views of
   one wider tensor) and the rwkv6-7b prefill shape (float32, and the
   model's types with two draws of the decay), under a gate scaled to
   the output; each case logs the kernel ``wkv6`` chose. At the bf16
   prefill shape the first kernel (``fma``) is held too, and the mma
   kernel, the fma kernel and the plain version are timed in turns
   beside the bound (no PyTorch call computes the recurrence);
5. serve: the full granite-8b configuration in bf16 (random weights from
   a seed) serves 8 seeded requests through ``ServingEngine``; the
   launch counts show every prefill attention call went through the
   sm90 kernel; then
   one prefill call and one decode step run under torch.profiler (wall
   time, device-busy share, the kernels that take the most time);
6. token equality: the same geometry at full width with 2 layers in
   float32 — continuous-batched greedy output equals the port's own
   sequential prefill + decode_step, token for token, save at near-ties
   within the measured batched-vs-sequential logit difference;
7. rwkv generate: the full rwkv6-7b configuration in bf16 (random
   weights from a seed): one ``prefill`` of 8 prompts of 1024 tokens,
   then 31 greedy ``decode_step`` calls; the launch counts show every
   layer's prefill went through the mma RWKV6 kernel and no decode step
   launched one; then one prefill and one decode step under
   torch.profiler;
8. rwkv equality: full width, 2 layers, float32 — batched greedy output
   equals each request generated alone (near-tie rule of phase 6), and
   prefill of 512 tokens then ``decode_step`` on the next 512 (the
   kernel seeded with a non-zero state) matches one prefill of 1024 in
   logits and every state leaf;
9. plan: trace → partition → plan for full granite-8b's paged decode
   step (bf16, random weights from a seed) at the serve phase's
   geometry. At the reduced size the graph's fingerprint must be the
   same traced on the CPU and on the card; at
   full width the trace's matmul FLOPs must equal a count from the
   config; ParDNN partitions it at K=4 under a quarter of the card per
   PE and under a tight cap (1.2 x (resident + largest transient bytes)
   / 4), every node in [0, 4) and, where the plan says feasible, every
   peak under its planned cap; the plan is saved, loaded and bound to a
   fresh trace (fingerprint and assignment equal); then the predicted
   step time (emulated makespan, one PE and K=4) is printed beside the
   measured eager step (wall, and device time under torch.profiler). No
   kernel launches on this path (one query token).

``--phases`` (a comma list of the names in ``PHASES``; default all) runs
a subset, for iterating on one kernel; the card's name is always read.
The line before the last is the ``kernels`` JSON record (the records of
the kernel phases that ran; ``launches`` is null where the main path that
would count them did not run); the last line is ``{"ok": true, "device":
{...}}``.
Without a CUDA card, or without the rest of the repository beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, float32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# the reference's kernel test cases (tests/test_kernels.py), plus the
# granite-8b prefill shape the serving phase gives the kernel
FLASH_CASES = [
    # (B, H, KV, S, hd, causal, window, dtype)
    (2, 4, 2, 256, 64, True, None, "float32"),
    (1, 4, 4, 128, 128, False, None, "float32"),
    (2, 8, 2, 256, 64, True, 64, "float32"),
    (1, 2, 1, 100, 80, True, None, "float32"),
    (1, 4, 2, 128, 64, True, None, "bfloat16"),
    (1, 2, 2, 64, 32, True, 16, "bfloat16"),
    (2, 2, 1, 192, 64, True, 128, "float32"),
]
GRANITE_PREFILL = (8, 32, 8, 1024, 128, True, None, "bfloat16")
GRANITE_PREFILL_F32 = GRANITE_PREFILL[:-1] + ("float32",)
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# At the granite shape 5e-2 is as large as a typical output, so every bf16
# kernel output is also held to the plain version run in float32 on the
# same bf16 inputs. The kernels keep scores and the accumulator in
# float32 (the fma kernel the probabilities too; the sm90 kernel takes P
# as bf16 hi + lo parts, exact to about 2^-17) and round only their
# output, so they may differ by that rounding (at most 2^-8 relative) and
# float32 summation order: the gate is one bf16 step, 2^-7 relative, over
# an absolute 1e-5.
TIGHT = {"atol": 1e-5, "rtol": 2.0 ** -7}
# the edges of the bf16 Hopper kernel (flash_attention_sm90.cu), each held
# to TOL and TIGHT; kv_view: k and v are views of a cache twice as long
SM90_CASES = [
    # (B, H, KV, Sq, Sk, hd, causal, window, q_offset, softcap, kv_view)
    (2, 4, 2, 256, 256, 64, True, None, 0, 0.0, False),
    (1, 4, 4, 128, 128, 128, False, None, 0, 0.0, False),
    (2, 8, 2, 256, 256, 64, True, 64, 0, 0.0, False),
    (2, 2, 1, 192, 192, 64, True, 128, 0, 0.0, False),
    (2, 4, 2, 1000, 1000, 128, True, None, 0, 0.0, False),   # ragged
    (2, 8, 2, 512, 1024, 128, True, None, 512, 0.0, False),  # with a cache
    (2, 8, 2, 1024, 1024, 128, True, 256, 0, 0.0, False),    # window
    (2, 8, 2, 512, 512, 128, True, None, 0, 30.0, False),    # soft cap
    (2, 8, 2, 300, 1000, 128, True, None, 700, 0.0, True),   # k, v views
    (8, 12, 4, 1024, 1024, 64, True, None, 0, 0.0, False),   # repro-lm-100m
]

# the reference's RWKV6 kernel cases (tests/test_kernels.py), a ragged
# length, and the rwkv6-7b prefill shape (B=8, S=1024, H=64, hd=64)
RWKV_CASES = [
    # (B, H, S, hd, chunk, dtype of r, k, v)
    (2, 2, 128, 64, 32, "float32"),
    (1, 4, 96, 64, 64, "float32"),
    (2, 1, 70, 32, 16, "float32"),
    (1, 2, 64, 64, 64, "bfloat16"),
    (1, 1, 33, 16, 8, "float32"),
    (2, 4, 1000, 64, 64, "bfloat16"),
]
# the edges of the bf16 tensor-core kernel (rwkv6_mma.cu), each with zero
# and random state0; view: r, k, v are views of one (B, S, 3, H, hd)
# tensor (16-byte aligned strides, as the kernel's cp.async needs)
MMA_CASES = [
    # (B, H, S, hd, chunk, dtype, view)
    (1, 2, 130, 64, 32, "bfloat16", False),    # chunk 32, ragged tail
    (2, 1, 77, 64, 16, "bfloat16", False),     # chunk 16, ragged tail
    (2, 2, 1, 64, 64, "bfloat16", False),      # one token
    (2, 4, 200, 64, 64, "bfloat16", True),     # r, k, v views
]
RWKV_PREFILL = (8, 64, 1024, 64, 64, "bfloat16")
RWKV_PREFILL_F32 = RWKV_PREFILL[:-1] + ("float32",)
# The kernel and its plain version compute in float32 from the same
# inputs and differ only in the order of their sums, ~1e-6 of the
# output's scale: the gate is max |diff| <= 2e-5 * max(1, max |plain|),
# for y and the final state each.
RWKV_GATE = 2e-5
# prefill-of-512 + decode_step-of-512 against one prefill of 1024, float32:
# the same arithmetic save cuBLAS's choice of kernel for other row counts;
# held to the port's model tolerance against the reference, 1e-4 of the
# scale.
SPLIT_GATE = 1e-4


# The kernel wrappers whose launch counts the main paths read, by name
# (filled in by main()).
COUNTED: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    """Every kernel's launch counts (the total and, where a wrapper has
    several kernels, each one's) to 0, just before a main path runs."""
    for fn in COUNTED.values():
        fn.launches = 0
        for variant in getattr(fn, "variant_launches", {}):
            fn.variant_launches[variant] = 0


def read_counts() -> dict:
    """{name: total, "name/variant": that kernel's launches}."""
    counts = {}
    for name, fn in COUNTED.items():
        counts[name] = fn.launches
        for variant, n in getattr(fn, "variant_launches", {}).items():
            counts[f"{name}/{variant}"] = n
    return counts


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 3,
            rounds: int = 3) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around
    ``reps`` back-to-back calls, over the count, the median of
    ``rounds`` such runs. Back to back, the host enqueues a call while
    the device runs the one before, so the wrapper's host time stays out
    of the number unless it exceeds the device time (events around each
    single call would count it in)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def timed_turns(torch, fns: dict, reps: dict, rounds: int = 3) -> dict:
    """Device ms of one call of each function, timed in turns (each
    round times every function once with :func:`cuda_ms`), the median
    over the rounds: drift of the card's clock or power hits all of them
    alike."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(cuda_ms(torch, fn, reps=reps.get(name, 10),
                                       rounds=1))
    return {name: statistics.median(t) for name, t in times.items()}


def visible_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave, i.e. the work these inputs
    need."""
    qp = np.arange(Sq)
    hi = np.minimum(Sk, qp + 1) if causal else np.full(Sq, Sk)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def phase_card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = res.stdout.strip().splitlines()[0]
    log(card)
    return card


def phase_build(libs: dict, build) -> float:
    """Build every kernel library at once (one nvcc each, in threads)."""
    def timed(ops):
        t0 = time.perf_counter()
        ops.load()
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        secs = dict(zip(libs, pool.map(timed, libs.values())))
    total = time.perf_counter() - t0
    for name, ops in libs.items():
        so, _ = build.library_path(name, ops.CSRC)
        log(f"build: {name} in {secs[name]:.1f} s -> "
            f"{so.relative_to(ROOT)}")
        # one line per kernel: its (mangled) name, registers, spills
        kernel = spills = ""
        for line in so.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "spill" in line:
                spills = line.strip()
            elif "Used" in line:
                log(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}; "
                    f"{spills}")
    log(f"build: {len(libs)} libraries in {total:.1f} s")
    return total


def _inputs(torch, case, seed):
    B, H, KV, S, hd, _, _, dtype = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)
    return rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)


def _hold(torch, ref, label, out, q, k, v, dtype, **kw) -> tuple:
    """The kernel's output against the plain version on the same inputs
    (TOL), and in bf16 also against the plain version run in float32
    (TIGHT). Returns (max |out - plain|, TIGHT ratio or None): the worst
    |out - plain32| over its allowance, which holds while <= 1."""
    plain = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    ok = torch.allclose(out.float(), plain.float(), atol=TOL[dtype],
                        rtol=TOL[dtype]) and bool(torch.isfinite(out).all())
    tight = None
    if dtype == "bfloat16":
        plain32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                          **kw)
        tight = ((out.float() - plain32).abs() / (
            TIGHT["atol"] + TIGHT["rtol"] * plain32.abs())).max().item()
        ok = ok and tight <= 1
        del plain32
    log(f"kernel flash_attention {label}: max_abs_err {err:.3g} (tol "
        f"{TOL[dtype]})" + ("" if tight is None else
                            f", error / TIGHT {tight:.3g}")
        + f" {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {label}")
    return err, tight


def phase_kernels(torch, ops, ref) -> dict:
    """Both flash kernels vs the plain version at every case; times at
    the prefill shape. Returns the sm90 kernel's record; its launches stay
    None unless the serve phase runs and fills them in."""
    import torch.nn.functional as F
    sm90 = ops.flash_attention.variant_launches
    for i, case in enumerate(FLASH_CASES + [GRANITE_PREFILL_F32]):
        B, H, KV, S, hd, causal, window, dtype = case
        q, k, v = _inputs(torch, case, seed=i)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        variant = ops.select_variant(q.dtype, hd)
        _hold(torch, ref, f"{case} [{variant}]", out, q, k, v, dtype,
              causal=causal, window=window)
    for i, case in enumerate(SM90_CASES):
        B, H, KV, Sq, Sk, hd, causal, window, q_offset, softcap, view = case
        g = torch.Generator(device="cuda").manual_seed(100 + i)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").bfloat16()
        q = rnd(B, Sq, H, hd)
        k, v = rnd(B, 2 * Sk, KV, hd), rnd(B, 2 * Sk, KV, hd)
        k, v = (k[:, :Sk], v[:, Sk:]) if view else \
            (k[:, :Sk].contiguous(), v[:, :Sk].contiguous())
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  softcap=softcap)
        before = sm90["sm90"]
        out = ops.flash_attention(q, k, v, **kw)
        assert sm90["sm90"] == before + 1, f"{case} did not run sm90"
        _hold(torch, ref, f"{case} [sm90]", out, q, k, v, "bfloat16", **kw)

    # the granite-8b prefill shape: both kernels held to the plain version,
    # then all four timed in turns
    B, H, KV, S, hd, causal, window, dtype = GRANITE_PREFILL
    q, k, v = _inputs(torch, GRANITE_PREFILL, seed=len(FLASH_CASES) + 1)
    kw = dict(causal=causal, window=window)
    assert ops.select_variant(q.dtype, hd) == "sm90"
    out = ops.flash_attention(q, k, v, **kw)
    err, tight = _hold(torch, ref, f"{GRANITE_PREFILL} [sm90]", out, q, k,
                       v, dtype, **kw)
    earlier = ops.run_variant("fma", q, k, v, **kw)
    _, earlier_tight = _hold(torch, ref, f"{GRANITE_PREFILL} [fma]", earlier,
                             q, k, v, dtype, **kw)
    # library yardstick: SDPA on (B, H, S, hd) with the KV heads repeated
    # for GQA (the repeat is outside the timed call)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    lib_err = (lib.transpose(1, 2).float() - out.float()).abs().max()
    ms = timed_turns(torch, {
        "sm90": lambda: ops.flash_attention(q, k, v, **kw),
        "fma": lambda: ops.run_variant("fma", q, k, v, **kw),
        "plain": lambda: ref.flash_attention_ref(q, k, v, **kw),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal),
    }, reps={"fma": 5, "plain": 5})
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    flops = 4 * B * H * hd * visible_pairs(S, S, causal, window)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    log(f"timing flash_attention at {GRANITE_PREFILL}, in turns: sm90 "
        f"{ms['sm90']:.4f} ms ({flops / ms['sm90'] / 1e9:.1f} TFLOP/s), "
        f"fma {ms['fma']:.4f} ms ({flops / ms['fma'] / 1e9:.2f} TFLOP/s), "
        f"plain {ms['plain']:.4f} ms, sdpa {ms['sdpa']:.4f} ms "
        f"({flops / ms['sdpa'] / 1e9:.1f} TFLOP/s; max |sdpa - sm90| "
        f"{lib_err.item():.3g}); bound {max(t_bytes, t_ops):.4f} ms "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 2**20:.1f} MiB); fma against "
        f"the float32 plain version: error / TIGHT {earlier_tight:.3g}")
    record = {
        "name": "flash_attention", "variant": "sm90", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:94",
        "launches": None, "variant_launches": None,
        "max_abs_err": err, "tight_gate_ratio": tight,
        "ms": ms["sm90"], "plain_ms": ms["plain"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": ms["sdpa"],
        "earlier_ms": ms["fma"],
        "earlier_source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention.cu",
    }
    del q, k, v, out, earlier, qt, kt, vt, lib
    torch.cuda.empty_cache()
    return record


def profile(torch, label: str, fn, top: int = 6) -> tuple[float, float]:
    """Host time, device-busy time and the kernels that take the most
    device time for one call of ``fn`` (torch.profiler, after warm-up).
    Returns (wall ms, device-busy ms)."""
    from torch.profiler import ProfilerActivity
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    log(f"profile {label}: wall {host_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / host_ms:.1%}), {sum(e.count for e in evs)} "
        f"kernels")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} "
            f"{e.key[:90]}")
    return host_ms, busy_ms


def _requests(Request, cfg, n, seed, plen=(128, 1024), max_new=32):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        int(rng.integers(plen[0],
                                                         plen[1] + 1))
                                        ).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n)]


GEOMETRY = dict(max_batch=8, max_len=2048, block_size=16, num_blocks=1025)


def phase_serve(torch, ops, cfg) -> dict:
    """Full granite-8b in bf16 through the engine; returns the kernels'
    launch counts of the measured run."""
    from repro_torch import obs
    from repro_torch.models import init_params, prefill_batched
    from repro_torch.serving import Request, ServingEngine
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.num_layers} layers d_model "
        f"{cfg.d_model} {cfg.dtype}, {cfg.param_count() / 1e9:.2f} B "
        f"params, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # warm-up: a separate engine, so cuBLAS and the allocator are set up
    # before the measured run
    warm = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    for r in _requests(Request, cfg, 1, seed=99, plen=(128, 128),
                       max_new=2):
        warm.submit(r)
    warm.run_until_drained()
    del warm
    torch.cuda.empty_cache()

    eng = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    reqs = _requests(Request, cfg, 8, seed=0)
    for r in reqs:
        eng.submit(r)
    tracer = obs.get_tracer()
    tracer.drain()
    obs.enable(True)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    obs.enable(False)
    spans = {}
    for ev in tracer.drain():
        if ev[0] == "X":
            spans.setdefault(ev[1], []).append(ev[6] / 1e3)   # ms
    s = eng.stats
    assert len(done) == len(reqs), f"{len(done)} of {len(reqs)} completed"
    assert all(len(r.output) == r.max_new_tokens for r in done.values())
    assert all(0 <= t < cfg.vocab_size for r in done.values()
               for t in r.output), "token outside the vocab"
    assert s.leaked_blocks == 0, f"{s.leaked_blocks} blocks leaked"
    want = cfg.num_layers * s.prefill_calls
    assert launches["flash_attention"] == want > 0, \
        f"flash_attention launched {launches['flash_attention']} times, " \
        f"expected {cfg.num_layers} x {s.prefill_calls} prefill calls"
    assert launches["flash_attention/sm90"] == want, \
        f"{launches['flash_attention/sm90']} of {want} prefill attention " \
        f"launches went to the sm90 kernel"
    assert launches["wkv6"] == 0, "granite-8b has no RWKV layer"
    summary = s.to_dict()
    prefill_ms = spans.get("serving/prefill_batch", [])
    decode_ms = spans.get("serving/decode_step", [])
    log(f"serve: {len(done)} requests, {s.prefill_tokens} prompt tokens, "
        f"{s.generated_tokens} generated in {wall:.3f} s -> "
        f"{s.generated_tokens / wall:.1f} tok/s; ttft p50 "
        f"{summary['ttft_p50_s']:.4f} s; {s.prefill_calls} prefill calls "
        f"({', '.join(f'{t:.1f}' for t in prefill_ms)} ms); "
        f"{s.decode_steps} decode steps, median "
        f"{statistics.median(decode_ms):.2f} ms; "
        f"{s.preempted} preemptions; peak "
        f"{s.peak_blocks_in_use}/{eng.allocator.capacity} blocks; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve: flash_attention launches {launches['flash_attention']} "
        f"= {cfg.num_layers} layers x {s.prefill_calls} prefill calls, "
        f"{launches['flash_attention/sm90']} of them sm90")
    # where the time goes: one prefill call and one decode step at this
    # geometry, under the profiler (after the measured run)
    B, W = eng.max_batch, eng.max_blocks_per_req
    tokens = torch.ones((B, 1024), dtype=torch.int32, device="cuda")
    plens = torch.full((B,), 1024, dtype=torch.int32, device="cuda")
    logits, _ = prefill_batched(cfg, params, tokens, plens)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    profile(torch, "prefill B=8 S=1024",
            lambda: prefill_batched(cfg, params, tokens, plens))
    bt = torch.arange(1, 1 + B * W, dtype=torch.int32,
                      device="cuda").reshape(B, W)
    lens = torch.full((B,), 1040, dtype=torch.int32, device="cuda")
    profile(torch, "decode step B=8 max_len=2048",
            lambda: eng._decode(bt, tokens[:, :1], lens))
    del eng, params, logits
    torch.cuda.empty_cache()
    return launches


def _stack_rows(torch, caches: list):
    """One batch from per-request caches (a copy; leaves under
    ``periods`` carry the batch on axis 1)."""
    from repro_torch.tree import tree_map_with_path
    return tree_map_with_path(
        lambda path, *rows: torch.cat(rows, dim=1 if path[0] == "periods"
                                      else 0), caches[0], *caches[1:])


def phase_token_equality(torch, cfg) -> None:
    """Continuous batching == sequential prefill + decode_step, float32,
    full width, 2 layers.

    A batched and a sequential call run cuBLAS in different summation
    orders, so their logits differ by some d, measured here at the
    prefill and at the first decode step. The sequential reference is
    fed the engine's tokens; at every step the engine's token must be
    the reference's argmax, or, where two logits lie within
    ``limit = 4 d`` of each other (a near-tie that d can flip), within
    ``limit`` of the reference's maximum."""
    from repro_torch.models import (decode_step, init_params, prefill,
                                    prefill_batched)
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         "cuda")
    eng = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    reqs = _requests(Request, cfg, 8, seed=1)
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    assert eng.stats.leaked_blocks == 0
    outs = [done[r.rid].output for r in reqs]
    plens = [len(r.prompt) for r in reqs]
    # sequential prefill, one request at a time
    seq = [prefill(cfg, params, {"tokens": torch.from_numpy(
        r.prompt[None]).cuda()}, GEOMETRY["max_len"]) for r in reqs]
    # batched-vs-sequential logit difference d: the padded batched
    # prefill the engine runs, and one decode step over the stacked
    # sequential caches at per-row positions
    S = 1 << max(3, (max(plens) - 1).bit_length())
    tokens = torch.zeros((len(reqs), S), dtype=torch.int32, device="cuda")
    for j, r in enumerate(reqs):
        tokens[j, :plens[j]] = torch.from_numpy(r.prompt)
    lens = torch.tensor(plens, dtype=torch.int32, device="cuda")
    b_logits, _ = prefill_batched(cfg, params, tokens, lens)
    d_prefill = max(float((b_logits[j, -1] - seq[j][0][0, -1]).abs().max())
                    for j in range(len(reqs)))
    first = torch.tensor([[o[0]] for o in outs], device="cuda")
    b_logits, _ = decode_step(cfg, params,
                              _stack_rows(torch, [c for _, c in seq]),
                              first, lens)
    # sequential decode, fed the engine's tokens; per step: (request,
    # step, top-2 gap, argmax, engine's token, how far its logit lies
    # below the maximum)
    d_decode, steps = 0.0, []
    for j, r in enumerate(reqs):
        logits, caches = seq[j]
        pos = plens[j]
        for i, tok in enumerate(outs[j]):
            row = logits[0, -1]
            if i == 1:
                d_decode = max(d_decode, float(
                    (b_logits[j, -1] - row).abs().max()))
            top2 = row.topk(2)
            steps.append((r.rid, i, float(top2.values[0] - top2.values[1]),
                          int(top2.indices[0]), tok,
                          float(top2.values[0] - row[tok])))
            if i + 1 < len(outs[j]):
                logits, caches = decode_step(
                    cfg, params, caches,
                    torch.tensor([[tok]], device="cuda"), pos)
                pos += 1
    limit = 4 * max(d_prefill, d_decode)
    ties = sum(gap <= limit for _, _, gap, _, _, _ in steps)
    flips = sum(tok != top for _, _, _, top, tok, _ in steps)
    mismatched = [(rid, i) for rid, i, _, top, tok, behind in steps
                  if tok != top and behind > limit]
    log(f"token equality: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"float32, {len(reqs)} requests x {reqs[0].max_new_tokens} tokens,"
        f" {eng.stats.prefill_calls} prefill calls; batched-vs-sequential "
        f"max |logit diff| prefill {d_prefill:.3g} decode {d_decode:.3g}, "
        f"near-tie limit {limit:.3g}; min top-2 logit gap "
        f"{min(s[2] for s in steps):.3g}; {ties} steps within the limit, "
        f"{flips} tokens differ from the sequential argmax, mismatched "
        f"(request, step) {mismatched}")
    assert not mismatched, f"continuous batching != sequential at " \
        f"{mismatched}"
    del eng, params, seq, b_logits
    torch.cuda.empty_cache()


def _rwkv_inputs(torch, case, seed, decay: str, state: bool,
                 view: bool = False):
    """r, k, v ~ N(0, 1) in the case's dtype (k ~ 0.3 N for the test
    draw); u ~ 0.1 N; decay from the reference test's distribution
    (``test``: w = exp(-exp(0.5 N - 2))) or the model's at init
    (``model``: w = exp(-exp(-6 + 0.05 N)), w0 = -6 and a small LoRA
    term); state0 ~ N(0, 1) or None. With ``view``, r, k and v are views
    of one (B, S, 3, H, hd) tensor."""
    B, H, S, hd, _, dtype = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    dt = getattr(torch, dtype)
    if view:
        rkv = n(B, S, 3, H, hd)
        rkv[:, :, 1] *= 0.3 if decay == "test" else 1.0
        r, k, v = rkv.to(dt).unbind(2)
    else:
        r, k, v = n(B, S, H, hd), n(B, S, H, hd), n(B, S, H, hd)
        k = k * 0.3 if decay == "test" else k
    if decay == "test":
        w = torch.exp(-torch.exp(n(B, S, H, hd) * 0.5 - 2.0))
    else:
        w = torch.exp(-torch.exp(-6.0 + 0.05 * n(B, S, H, hd)))
    u = n(H, hd) * 0.1
    s0 = n(B, H, hd, hd) if state else None
    return r.to(dt), k.to(dt), v.to(dt), w, u, s0


def _gate(out, plain) -> tuple[float, float]:
    """(max |out - plain|, that over the gate's allowance)."""
    err = (out - plain).abs().max().item()
    allow = RWKV_GATE * max(1.0, plain.abs().max().item())
    return err, err / allow


def _hold_rwkv(torch, ref, label, out, args, chunk) -> tuple:
    """A kernel's (y, S_last) against the plain version on the same
    inputs under RWKV_GATE, finite; logs and returns (max |y - plain|,
    the worse error / gate), and raises past 1."""
    y, s_last = out
    y_p, s_p = ref.wkv_ref(*args, chunk)
    torch.cuda.synchronize()
    (ey, ry), (es, rs) = _gate(y, y_p), _gate(s_last, s_p)
    ok = max(ry, rs) <= 1 and bool(torch.isfinite(y).all()) and \
        bool(torch.isfinite(s_last).all())
    log(f"kernel wkv6 {label}: max |y - plain| {ey:.3g} (max |y| "
        f"{y_p.abs().max().item():.3g}), max |S - plain| {es:.3g} (max |S| "
        f"{s_p.abs().max().item():.3g}); error / gate y {ry:.3g} S "
        f"{rs:.3g} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"wkv6 disagrees with its plain version at "
                             f"{label}")
    return ey, max(ry, rs)


def phase_rwkv_kernels(torch, ops, ref) -> dict:
    """Both RWKV6 kernels against the plain version, y and S_last, at
    every case; times at the rwkv6-7b prefill shape. Returns the mma
    kernel's record; its launches stay None unless the rwkv_generate
    phase runs and fills them in."""
    runs = [(c, "test", st) for c in RWKV_CASES + MMA_CASES
            for st in (False, True)]
    runs += [(RWKV_PREFILL_F32, "model", True),
             (RWKV_PREFILL, "model", True), (RWKV_PREFILL, "test", True)]
    counts = ops.wkv6.variant_launches
    worst, record = 0.0, None
    for i, (case, decay, state) in enumerate(runs):
        view = len(case) > 6 and case[6]
        args = _rwkv_inputs(torch, case, 100 + i, decay, state, view)
        r, k, v, w, u, s0 = args
        B, H, S, hd, chunk, dtype = case[:6]
        variant = ops.select_variant(r.dtype, hd)
        before = counts[variant]
        out = ops.wkv6(*args, chunk)
        assert counts[variant] == before + 1, f"{case} did not run {variant}"
        label = (f"{case} decay={decay} state0="
                 f"{'random' if state else 'zero'} [{variant}]")
        err, ratio = _hold_rwkv(torch, ref, label, out, args, chunk)
        worst = max(worst, ratio)
        if case is not RWKV_PREFILL:
            continue
        # the bf16 prefill shape: the first kernel held as well
        assert variant == "mma", f"wkv6 chose {variant} at {case}"
        earlier = ops.run_variant("fma", *args, chunk)
        _, earlier_ratio = _hold_rwkv(
            torch, ref, label.replace("[mma]", "[fma]"), earlier, args, chunk)
        if decay != "model":
            continue
        y, s_last = out
        ms = timed_turns(torch, {
            "mma": lambda: ops.wkv6(*args, chunk),
            "fma": lambda: ops.run_variant("fma", *args, chunk),
            "plain": lambda: ref.wkv_ref(*args, chunk),
        }, reps={"plain": 5})
        nbytes = sum(t.numel() * t.element_size()
                     for t in (r, k, v, w, u, s0, y, s_last))
        nchunks = -(-S // chunk)
        # four products per (b, h, chunk): r_in k_inᵀ (C x C x hd),
        # r_inter S (C x hd x hd), A v (C x C x hd), k_tailᵀ v (hd x C x hd)
        flops = 2 * B * H * nchunks * (2 * chunk * chunk * hd
                                       + 2 * chunk * hd * hd)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        blocks = ops.mma_blocks_per_sm()
        log(f"timing wkv6 at {case}, in turns: mma {ms['mma']:.4f} ms "
            f"({flops / ms['mma'] / 1e9:.2f} TFLOP/s, "
            f"{nbytes / ms['mma'] / 1e6:.1f} GB/s; {blocks} blocks per "
            f"SM), fma {ms['fma']:.4f} ms, plain {ms['plain']:.4f} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 2**20:.1f} MiB, "
            f"{flops / 1e9:.2f} GFLOP); fma error / gate "
            f"{earlier_ratio:.3g}; no PyTorch call computes the recurrence")
        record = {
            "name": "wkv6", "variant": "mma", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6_mma.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:74",
            "launches": None, "variant_launches": None,
            "max_abs_err": err, "ms": ms["mma"], "plain_ms": ms["plain"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "earlier_ms": ms["fma"],
            "earlier_source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu",
            "blocks_per_sm": blocks,
        }
        del earlier
    record["gate_ratio"] = worst
    log(f"kernel wkv6: {len(runs)} runs, worst error / gate {worst:.3g}")
    del args, out, r, k, v, w, u, s0
    torch.cuda.empty_cache()
    return record


def _greedy(torch, cfg, params, tokens, n_new: int):
    """prefill + (n_new - 1) greedy decode_step calls. Returns the
    generated tokens (B, n_new) and the logits of every step."""
    from repro_torch.models import decode_step, prefill
    B, S = tokens.shape
    logits, caches = prefill(cfg, params, {"tokens": tokens}, S + n_new)
    steps = [logits[:, -1]]
    out = [logits[:, -1].argmax(-1)]
    for i in range(n_new - 1):
        logits, caches = decode_step(cfg, params, caches, out[-1][:, None],
                                     S + i)
        out.append(logits[:, -1].argmax(-1))
        steps.append(logits[:, -1])
    return torch.stack(out, 1), steps


def phase_rwkv_generate(torch, cfg) -> dict:
    """Full rwkv6-7b in bf16: one prefill of 8 x 1024 tokens, 31 decode
    steps; returns the kernels' launch counts of that run."""
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    leaves = []
    tree_map(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    log(f"rwkv: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
        f"{cfg.dtype}, {n_params / 1e9:.3f} B parameters in the tensors "
        f"({cfg.param_count() / 1e9:.3f} B by the reference's analytic "
        f"count, which leaves out w_g and cm_r), init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    B, S, n_new = 8, 1024, 32
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S))
                              .astype(np.int32)).cuda()
    # warm-up (cuBLAS handles, the allocator), then the measured run
    _greedy(torch, cfg, params, tokens[:, :128], 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, params, {"tokens": tokens}, S + n_new)
    out = [logits[:, -1].argmax(-1)]
    out[-1].cpu()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = read_counts()
    step_ms = []
    for i in range(n_new - 1):
        t1 = time.perf_counter()
        logits, caches = decode_step(cfg, params, caches, out[-1][:, None],
                                     S + i)
        out.append(logits[:, -1].argmax(-1))
        out[-1].cpu()                     # the host needs the token
        step_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    gen = torch.stack(out, 1)
    assert gen.shape == (B, n_new)
    assert bool(((gen >= 0) & (gen < cfg.vocab_size)).all()), \
        "token outside the vocab"
    assert bool(torch.isfinite(logits).all())
    assert after_prefill["wkv6"] == cfg.num_layers > 0, \
        f"wkv6 launched {after_prefill['wkv6']} times in one prefill " \
        f"call, expected {cfg.num_layers}"
    assert after_prefill["wkv6/mma"] == cfg.num_layers, \
        f"{after_prefill['wkv6/mma']} of {cfg.num_layers} prefill wkv6 " \
        f"launches went to the mma kernel"
    assert launches["wkv6"] == after_prefill["wkv6"] and \
        launches["wkv6/mma"] == after_prefill["wkv6/mma"], \
        "a decode step launched an RWKV6 kernel"
    assert launches["flash_attention"] == 0, "rwkv6-7b has no attention"
    log(f"rwkv: {B} requests x {S} prompt tokens, {B * n_new} generated in "
        f"{wall:.3f} s -> {B * n_new / wall:.1f} tok/s; prefill (= TTFT) "
        f"{prefill_ms:.1f} ms; {n_new - 1} decode steps, median "
        f"{statistics.median(step_ms):.2f} ms (min {min(step_ms):.2f}, "
        f"max {max(step_ms):.2f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"rwkv: wkv6 launches {launches['wkv6']} = {cfg.num_layers} layers "
        f"x 1 prefill call, {launches['wkv6/mma']} of them mma; 0 in "
        f"{n_new - 1} decode steps")
    profile(torch, f"rwkv prefill B={B} S={S}",
            lambda: prefill(cfg, params, {"tokens": tokens}, S + n_new))
    profile(torch, f"rwkv decode step B={B}",
            lambda: decode_step(cfg, params, caches, out[-1][:, None],
                                S + n_new))
    del params, caches, logits
    torch.cuda.empty_cache()
    return launches


def phase_rwkv_equality(torch, cfg) -> None:
    """Full width, 2 layers, float32: (a) batched greedy == each request
    alone, with the near-tie rule of phase_token_equality; (b) prefill
    of 512 then decode_step of 512 == prefill of 1024."""
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_map_with_path
    cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         "cuda")
    B, S, n_new = 8, 1024, 32
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S))
                              .astype(np.int32)).cuda()
    gen, b_steps = _greedy(torch, cfg, params, tokens, n_new)
    # each request alone, fed the batched run's tokens; per step:
    # (request, step, top-2 gap, argmax, batched token, how far its logit
    # lies below the maximum)
    d_prefill = d_decode = 0.0
    steps = []
    for j in range(B):
        logits, caches = prefill(cfg, params, {"tokens": tokens[j:j + 1]},
                                 S + n_new)
        for i in range(n_new):
            row = logits[0, -1]
            d = float((b_steps[i][j] - row).abs().max())
            if i == 0:
                d_prefill = max(d_prefill, d)
            elif i == 1:
                d_decode = max(d_decode, d)
            top2 = row.topk(2)
            tok = int(gen[j, i])
            steps.append((j, i, float(top2.values[0] - top2.values[1]),
                          int(top2.indices[0]), tok,
                          float(top2.values[0] - row[tok])))
            if i + 1 < n_new:
                logits, caches = decode_step(cfg, params, caches,
                                             gen[j:j + 1, i:i + 1], S + i)
    limit = 4 * max(d_prefill, d_decode)
    ties = sum(gap <= limit for _, _, gap, _, _, _ in steps)
    flips = sum(tok != top for _, _, _, top, tok, _ in steps)
    mismatched = [(j, i) for j, i, _, top, tok, behind in steps
                  if tok != top and behind > limit]
    log(f"rwkv equality: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"float32, {B} requests x {n_new} tokens; batched-vs-alone max "
        f"|logit diff| prefill {d_prefill:.3g} decode {d_decode:.3g}, "
        f"near-tie limit {limit:.3g}; min top-2 logit gap "
        f"{min(st[2] for st in steps):.3g}; {ties} steps within the limit,"
        f" {flips} tokens differ from the alone argmax, mismatched "
        f"(request, step) {mismatched}")
    assert not mismatched, f"batched != alone at {mismatched}"

    # (b) the kernel seeded from a non-zero state on the main path
    half = S // 2
    full_logits, full = prefill(cfg, params, {"tokens": tokens}, S)
    _, split = prefill(cfg, params, {"tokens": tokens[:, :half]}, S)
    reset_counts()
    split_logits, split = decode_step(cfg, params, split, tokens[:, half:],
                                      half)
    assert read_counts()["wkv6"] == cfg.num_layers, \
        "decode_step with several tokens did not run the kernel"
    ratios = {}

    def compare(path, a, b):
        err = float((a.float() - b.float()).abs().max())
        scale = max(1.0, float(b.float().abs().max()))
        ratios["/".join(map(str, path))] = (err, err / (SPLIT_GATE * scale))
    compare(("logits",), split_logits[:, -1], full_logits[:, -1])
    tree_map_with_path(compare, split, full)
    worst = max(r for _, r in ratios.values())
    log(f"rwkv split prefill: prefill 512 + decode_step 512 vs prefill "
        f"1024: max |diff| " + ", ".join(
            f"{k} {e:.3g}" for k, (e, _) in ratios.items())
        + f"; worst error / gate ({SPLIT_GATE} of the scale) {worst:.3g} "
        f"{'ok' if worst <= 1 else 'MISMATCH'}")
    assert worst <= 1, "split prefill disagrees with one prefill"
    del params, full, split, full_logits, split_logits, b_steps
    torch.cuda.empty_cache()


def decode_matmul_flops(cfg, batch: int, max_len: int) -> float:
    """Matmul FLOPs of one paged decode step, counted from the config
    (independently of any trace): the q/k/v/o projections, the MLP,
    attention of one query over the ``max_len`` view (scores and the
    weighted sum), and the LM head, for ``batch`` rows."""
    d, hd = cfg.d_model, cfg.head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    proj = 2 * batch * d * (2 * q + 2 * kv)
    mlp = (3 if cfg.gated_mlp else 2) * 2 * batch * d * cfg.d_ff
    attn = 2 * 2 * batch * cfg.num_heads * max_len * hd
    head = 2 * batch * d * cfg.padded_vocab
    return float(cfg.num_layers * (proj + mlp + attn) + head)


def phase_plan(torch, cfg) -> None:
    """Trace → partition → plan for the paged decode step at full
    granite-8b width (bf16, random weights from a seed) at the serve
    phase's geometry: trace on cuda with the program recorded, the
    matmul FLOPs held to a count from the config; partition at K=4 under
    a quarter of the card and under a tight cap; save, load and bind the
    plan to a fresh trace; the predicted step time beside the measured
    eager step. First, at the reduced size, the graph's fingerprint must
    be the same for a trace on the CPU and on the card."""
    import tempfile
    from repro_torch import api
    from repro_torch.configs import reduced
    from repro_torch.core.costmodel import H100
    from repro_torch.core.emulator import emulate
    from repro_torch.core.graph import RESIDUAL
    from repro_torch.core.tracing import DOT_OPS
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import tree_map

    small = reduced(cfg)
    cpu_params = init_params(small, torch.Generator().manual_seed(0), "cpu")
    prints = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        eng = ServingEngine(small, params, device=dev, **GEOMETRY)
        prints[dev] = api.trace(eng._decode_impl,
                                *eng._decode_example_args()).fingerprint
    assert len(set(prints.values())) == 1, \
        f"the reduced graph's fingerprint depends on the device: {prints}"
    log(f"plan: reduced {small.name} fingerprint {prints['cpu'][:16]} on "
        f"cpu and cuda")
    del cpu_params, params, eng

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    eng = ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    reset_counts()
    t0 = time.perf_counter()
    traced = api.trace(eng._decode_impl, *eng._decode_example_args(),
                       record=True)
    trace_s = time.perf_counter() - t0
    g = traced.graph
    n_edges = sum(len(e) for e in g.out_edges)
    res_bytes = float(g.mem[g.ntype == RESIDUAL].sum())
    transient = float(g.mem[g.ntype != RESIDUAL].max())
    mm = float(sum(g.op_flops[i] for i in range(g.n)
                   if g.names[i] in DOT_OPS))
    want = decode_matmul_flops(cfg, GEOMETRY["max_batch"],
                               GEOMETRY["max_len"])
    log(f"plan: traced {cfg.name} decode step (B={GEOMETRY['max_batch']}, "
        f"max_len={GEOMETRY['max_len']}) on cuda in {trace_s:.2f} s: "
        f"{g.n} nodes, {n_edges} edges, {len(traced.program.input_nodes)} "
        f"input leaves, RESIDUAL {res_bytes / 2**30:.3f} GiB, largest "
        f"transient {transient / 2**30:.3f} GiB, {g.op_flops.sum():.6g} "
        f"FLOPs, matmul {mm:.6g} (from the config {want:.6g})")
    assert mm == want, f"matmul FLOPs {mm} != {want} counted from the config"

    k = 4
    card = torch.cuda.get_device_properties(0).total_memory
    caps = {"quarter": card / k,
            "tight": 1.2 * (res_bytes + transient) / k}
    plans = {}
    for label, cap in caps.items():
        t0 = time.perf_counter()
        plan = api.partition(traced, devices=k, memory=cap)
        part_s = time.perf_counter() - t0
        a, peaks = plan.assignment, plan.peak_mem
        assert a.shape == (g.n,) and a.min() >= 0 and a.max() < k, \
            f"{label}: a node is assigned outside [0, {k})"
        planned = cap * api.PardnnOptions().memory_fraction
        if plan.feasible:
            assert (peaks <= planned).all(), \
                f"{label}: feasible, but peaks {peaks} exceed {planned}"
        stages = {st: round(t, 3)
                  for st, t in plan.report.stage_seconds.items()}
        cut, cut_by_src = 0, {}
        for u in range(g.n):
            for v, c in g.out_edges[u]:
                if a[u] != a[v]:
                    cut += 1
                    src = g.names[u].split(".")[0]
                    cut_by_src[src] = cut_by_src.get(src, 0.0) + \
                        (c - H100.link_latency) * H100.link_bw
        cut_bytes = sum(cut_by_src.values())
        top_cut = sorted(cut_by_src.items(), key=lambda x: -x[1])[:3]
        log(f"plan: K={k} {label} cap {cap / 2**30:.3f} GiB per PE "
            f"(planned to {planned / 2**30:.3f}): partition {part_s:.2f} s, "
            f"feasible={plan.feasible}, peaks "
            f"[{', '.join(f'{p / 2**30:.3f}' for p in peaks)}] GiB, moved "
            f"{plan.report.moved_nodes} nodes in "
            f"{plan.report.counters.get('step2_rounds')} Step-2 rounds, "
            f"{cut} cut edges, {cut_bytes / 2**20:.1f} MiB cut ("
            + ", ".join(f"from {n} {b / 2**20:.1f}" for n, b in top_cut)
            + f"), makespan {plan.makespan * 1e3:.3f} ms; stages {stages}")
        plans[label] = plan

    plan = plans["quarter"]
    with tempfile.TemporaryDirectory() as tmp:
        path = plan.save(str(Path(tmp) / "granite-decode.plan.json"))
        loaded = api.PartitionPlan.load(path)
    t0 = time.perf_counter()
    fresh = api.trace(eng._decode_impl, *eng._decode_example_args(),
                      record=True)
    retrace_s = time.perf_counter() - t0
    loaded.bind(fresh)
    assert loaded.fingerprint == fresh.fingerprint == traced.fingerprint
    assert loaded.assignment.dtype == plan.assignment.dtype
    assert np.array_equal(loaded.assignment, plan.assignment), \
        "the loaded plan's assignment differs"
    log(f"plan: saved, loaded and bound to a fresh trace ({retrace_s:.2f} "
        f"s): fingerprint and assignment equal")

    one_pe = emulate(g, np.zeros(g.n, dtype=np.int64), 1).makespan
    by_op: dict = {}
    for i in range(g.n):
        name = g.names[i].split(".")[0]
        by_op[name] = by_op.get(name, 0.0) + float(g.comp[i])
    top = sorted(by_op.items(), key=lambda x: -x[1])[:6]
    log(f"plan: predicted step on one PE {one_pe * 1e3:.3f} ms "
        f"({', '.join(f'{n} {t * 1e3:.2f}' for n, t in top)} ms), at K={k} "
        f"(quarter cap) {plan.makespan * 1e3:.3f} ms")
    B, W = eng.max_batch, eng.max_blocks_per_req
    bt = torch.arange(1, 1 + B * W, dtype=torch.int32,
                      device="cuda").reshape(B, W)
    toks = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    lens = torch.full((B,), 1040, dtype=torch.int32, device="cuda")
    walls = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._decode(bt, toks, lens)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms, busy_ms = profile(
        torch, "plan: eager decode step B=8 max_len=2048",
        lambda: eng._decode(bt, toks, lens), top=3)
    launches = read_counts()
    assert not any(launches.values()), \
        f"a kernel launched on the plan path (one query token): {launches}"
    log(f"plan: measured eager step median {statistics.median(walls):.2f} "
        f"ms wall over {len(walls)} steps; profiled {wall_ms:.2f} ms wall, "
        f"{busy_ms:.2f} ms device; predicted one PE {one_pe * 1e3:.3f} ms, "
        f"K={k} {plan.makespan * 1e3:.3f} ms")
    del eng, params, traced, fresh, plans, plan, loaded
    torch.cuda.empty_cache()


PHASES = ("build", "kernels", "rwkv_kernels", "serve",
          "token_equality", "rwkv_generate", "rwkv_equality", "plan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all)")
    phases = ap.parse_args(argv).phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; known: {', '.join(PHASES)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import ops, ref
        from repro_torch.kernels.rwkv6 import ops as rops
        from repro_torch.kernels.rwkv6 import ref as rref
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    COUNTED.update(flash_attention=ops.flash_attention, wkv6=rops.wkv6)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    card = phase_card()
    if "build" in phases:
        phase_build({"flash_attention": ops, "rwkv6": rops}, build)
    record = rwkv_record = None
    if "kernels" in phases:
        record = phase_kernels(torch, ops, ref)
    if "rwkv_kernels" in phases:
        rwkv_record = phase_rwkv_kernels(torch, rops, rref)
    cfg = get_config("granite-8b")
    if "serve" in phases:
        launches = phase_serve(torch, ops, cfg)
        if record is not None:
            record["launches"] = launches["flash_attention"]
            record["variant_launches"] = {
                v: launches[f"flash_attention/{v}"] for v in ops.VARIANTS}
    if "token_equality" in phases:
        phase_token_equality(torch, cfg)
    rcfg = get_config("rwkv6-7b")
    if "rwkv_generate" in phases:
        rwkv_launches = phase_rwkv_generate(torch, rcfg)
        if rwkv_record is not None:
            rwkv_record["launches"] = rwkv_launches["wkv6"]
            rwkv_record["variant_launches"] = {
                v: rwkv_launches[f"wkv6/{v}"] for v in rops.VARIANTS}
    if "rwkv_equality" in phases:
        phase_rwkv_equality(torch, rcfg)
    if "plan" in phases:
        phase_plan(torch, cfg)
    log(card)
    print(json.dumps({"kernels": [r for r in (record, rwkv_record)
                                  if r is not None]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
