"""Ablations of the mma wkv6 backward (``csrc/rwkv6_bwd_mma.cu``) on the
card: where its time goes.

    PYTHONPATH=src python -m repro_torch.kernels.rwkv6.ablate

Builds copies of the source, each with one part taken out by a text
substitution (a substitution that does not find its text fails the run),
into ``build/repro_torch_kernels/ablate_bwd/``, one ``nvcc`` each, in
parallel. Then times every copy at the rwkv6-7b training shape (B=1,
S=2048, H=64, hd=64, bf16, chunk 64): the whole call with CUDA events
around back-to-back calls, in turns, median of 3 turns, and each of its
two kernels (the state walks, the gradient pass) with torch.profiler.
Only ``kernel`` computes the gradient (it is held to the plain version
first); the others are instruments:

* ``kernel``: the source as it is;
* ``no_mma``: every product taken out, with its fragment loads and
  3xTF32 splits (both kernels);
* ``grad_loads_only``: the gradient pass returns once its tiles are in
  shared memory;
* ``walk_loads_only``: the walks load each chunk and write the
  workspaces, without the prefix sum, the factors or the product;
* ``walk_no_ws``: the walks write no workspace.

Prints one line per copy and, last, a JSON object of the times in ms.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import build
from . import ops
from .ref import wkv_bwd_ref

SOURCE = ops.CSRC / "rwkv6_bwd_mma.cu"
HEADER = ops.CSRC / "rwkv6_ptx.cuh"
KERNELS = ("wkv6_bwd_walk_mma", "wkv6_bwd_grad_mma")
ABLATIONS = {
    "kernel": [],
    "no_mma": [('  static_assert(NT <= N, "more tiles than accumulators");\n',
                '  static_assert(NT <= N, "more tiles than accumulators");\n'
                '  return;\n')],
    "grad_loads_only": [("  wkv::cp_async_wait_all();\n  __syncthreads();\n\n",
                         "  wkv::cp_async_wait_all();\n  __syncthreads();\n"
                         "  return;\n\n")],
    "walk_loads_only": [("    // prefix sums of log2 w over each 8-token segment",
                         "    continue;\n    // prefix sums of log2 w over "
                         "each 8-token segment")],
    "walk_no_ws": [("          *reinterpret_cast<float2*>(ws + row * D + col) =",
                    "          if (false) *reinterpret_cast<float2*>(ws + row "
                    "* D + col) =")],
}
SHAPE = dict(B=1, S=2048, H=64, hd=64, chunk=64)


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in ABLATIONS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"ablation {name}: {old!r} is not once in "
                               f"{SOURCE.name}")
        text = text.replace(old, new)
    return text


def build_variant(name: str):
    """Compile one copy into its own library and bind its entry point."""
    out = build.BUILD_DIR / "ablate_bwd" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE.name).write_text(variant_source(name))
    shutil.copy(HEADER, out / HEADER.name)
    so = out / "lib.so"
    res = subprocess.run([build._nvcc(), "-shared", *build.NVCC_FLAGS,
                          "-o", str(so), str(out / SOURCE.name)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on ablation {name}:\n{res.stderr}")
    fn = ctypes.CDLL(str(so)).repro_wkv6_bwd_mma
    fn.argtypes = ops._BWD_MMA_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate: no CUDA card", file=sys.stderr)
        return 2
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:
        fns = dict(zip(ABLATIONS, pool.map(build_variant, ABLATIONS)))
    B, S, H, hd, chunk = SHAPE.values()
    n = -(-S // chunk)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (rnd(B, S, H, hd).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 0.05 * rnd(B, S, H, hd)))
    u, s0, dy, ds = (0.1 * rnd(H, hd), rnd(B, H, hd, hd), rnd(B, S, H, hd),
                     rnd(B, H, hd, hd))
    outs = [torch.empty_like(r) for _ in range(3)] + [
        torch.empty_like(w), torch.empty((B, H, n, hd), device="cuda"),
        torch.empty_like(s0)] + [
        torch.empty((B, H, n, hd, hd), device="cuda") for _ in range(2)]
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn) -> None:
        err = fn(*(t.data_ptr() for t in (r, k, v, w, u, s0, dy, ds)),
                 *(t.data_ptr() for t in outs), 1, B, S, H, hd, chunk,
                 *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *w.stride()[:3], *dy.stride()[:3], *r.stride()[:3], stream)
        if err != 0:
            raise RuntimeError(f"launch failed ({err})")

    call(fns["kernel"])
    got = outs[:4] + [outs[4].sum((0, 2)), outs[5]]
    for i, (a, b) in enumerate(zip(got, wkv_bwd_ref(r, k, v, w, u, s0, dy,
                                                    ds, chunk))):
        top = b.abs().max().item()
        err = (a.float() - b).abs().max().item()
        if not err <= 2e-5 * max(1.0, top) + (2.0 ** -7 * top if i < 3
                                              else 0.0):
            raise AssertionError(f"the kernel copy disagrees with the "
                                 f"plain version: gradient {i}, max |diff| "
                                 f"{err}")

    def ms(fn, reps: int = 20) -> float:
        for _ in range(3):
            call(fn)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call(fn)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def by_kernel(fn, calls: int = 5) -> dict:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call(fn)
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        return {name: sum(e.self_device_time_total for e in evs
                          if name in e.key) / 1e3 / calls
                for name in KERNELS}

    runs = {name: [] for name in fns}
    for _ in range(3):
        for name, fn in fns.items():
            runs[name].append(ms(fn))
    times = {}
    for name, fn in fns.items():
        split = by_kernel(fn)
        times[name] = {"call": statistics.median(runs[name]), **split}
        print(f"ablate {name:16s} {times[name]['call']:.4f} ms a call; "
              + ", ".join(f"{k} {t:.4f}" for k, t in split.items()))
    print(json.dumps({"ablate_ms": times, "shape": SHAPE,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
