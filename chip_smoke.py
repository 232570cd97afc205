#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and
``nvcc``. Phases, each of which fails the run if it fails:

1. card: the card's name and power limit, as nvidia-smi reports them;
2. build: every CUDA kernel of the serving path, from the sources in
   this checkout, into ``build/repro_torch_kernels/``;
3. kernels: each kernel against its plain PyTorch version at the
   reference's test shapes and at the granite-8b prefill shape (in
   float32 as well; in bf16 also against the plain version run in
   float32, to one bf16 step), with times (CUDA events, median of
   repeats) beside the roofline bound and one PyTorch library call
   computing the same function;
4. serve: the full granite-8b configuration in bf16 (random weights from
   a seed) serves 8 seeded requests through ``ServingEngine``; the
   launch counts show prefill attention went through the kernel; then
   one prefill call and one decode step run under torch.profiler (wall
   time, device-busy share, the kernels that take the most time);
5. token equality: the same geometry at full width with 2 layers in
   float32 — continuous-batched greedy output equals the port's own
   sequential prefill + decode_step, token for token, save at near-ties
   within the measured batched-vs-sequential logit difference.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
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
# At the granite shape 5e-2 is as large as a typical output, so the bf16
# kernel is also held to the plain version run in float32 on the same
# bf16 inputs. The kernel keeps scores, probabilities and the accumulator
# in float32 and rounds only its output, so it may differ by that
# rounding (at most 2^-8 relative) and float32 summation order: the gate
# is one bf16 step, 2^-7 relative, over an absolute 1e-5.
TIGHT = {"atol": 1e-5, "rtol": 2.0 ** -7}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_build(ops, build) -> float:
    t0 = time.perf_counter()
    ops.load()
    secs = time.perf_counter() - t0
    so, _ = build.library_path("flash_attention", ops.CSRC)
    log(f"build: flash_attention in {secs:.1f} s -> "
        f"{so.relative_to(ROOT)}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas {line.strip()}")
    return secs


def _inputs(torch, case, seed):
    B, H, KV, S, hd, _, _, dtype = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)
    return rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)


def phase_kernels(torch, ops, ref) -> dict:
    """Kernel vs plain version at every case; times at the prefill
    shape. Returns the kernel's record (launches filled in later)."""
    import torch.nn.functional as F
    record = None
    cases = FLASH_CASES + [GRANITE_PREFILL_F32, GRANITE_PREFILL]
    for i, case in enumerate(cases):
        B, H, KV, S, hd, causal, window, dtype = case
        q, k, v = _inputs(torch, case, seed=i)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        plain = ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        ok = torch.allclose(out.float(), plain.float(), atol=TOL[dtype],
                            rtol=TOL[dtype])
        log(f"kernel flash_attention {case}: max_abs_err {err:.3g} "
            f"(tol {TOL[dtype]}) {'ok' if ok else 'MISMATCH'}")
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention disagrees with its "
                                 f"plain version at {case}")
        if case is not GRANITE_PREFILL:
            continue
        plain32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                          causal=causal, window=window)
        diff32 = (out.float() - plain32).abs()
        # worst |diff| over its allowance: the gate holds while <= 1
        tight = (diff32 / (TIGHT["atol"] + TIGHT["rtol"] * plain32.abs())
                 ).max().item()
        log(f"kernel flash_attention {case} against the float32 plain "
            f"version: max_abs_err {diff32.max().item():.3g}, RMS of the "
            f"output {plain32.pow(2).mean().sqrt().item():.3g}, worst "
            f"error / (atol {TIGHT['atol']} + rtol {TIGHT['rtol']} |o|) "
            f"{tight:.3g} {'ok' if tight <= 1 else 'MISMATCH'}")
        if not tight <= 1:
            raise AssertionError(f"flash_attention (bf16) disagrees with "
                                 f"the float32 plain version at {case}")
        del plain32, diff32
        ms = cuda_ms(torch, lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window))
        plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window), reps=5)
        # library yardstick: SDPA on (B, H, S, hd) with the KV heads
        # repeated for GQA (the repeat is outside the timed call)
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        lib_err = (lib.transpose(1, 2).float() - plain.float()).abs().max()
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
        flops = 4 * B * H * hd * visible_pairs(S, S, causal, window)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        log(f"timing flash_attention at {case}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms (max |sdpa - plain| "
            f"{lib_err.item():.3g}), {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 2**20:.1f} MiB")
        record = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:94",
            "launches": 0, "max_abs_err": err,
            "tight_gate_ratio": tight, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
        }
        del q, k, v, out, plain, qt, kt, vt, lib
    return record


def profile(torch, label: str, fn, top: int = 6) -> None:
    """Host time, device-busy time and the kernels that take the most
    device time for one call of ``fn`` (torch.profiler, after warm-up)."""
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
    ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": ops.flash_attention.launches}
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
        f"= {cfg.num_layers} layers x {s.prefill_calls} prefill calls")
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


def main() -> int:
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
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    card = phase_card()
    phase_build(ops, build)
    record = phase_kernels(torch, ops, ref)
    cfg = get_config("granite-8b")
    launches = phase_serve(torch, ops, cfg)
    phase_token_equality(torch, cfg)
    record["launches"] = launches["flash_attention"]
    log(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
