"""Ablations of the ``reg`` selective-scan backward
(``csrc/selective_scan_reg_bwd.cu``) on the card, where its time goes,
and the ``reg`` kernels at each state split they are built for.

    PYTHONPATH=src python -m repro_torch.kernels.ssm.ablate

Builds copies of the source, each with one part taken out (or one
constant changed) by a text substitution (a substitution that does not
find its text once fails the run), into
``build/repro_torch_kernels/ablate_ssm/``, one ``nvcc`` each, in
parallel. Then times every copy at jamba's training shape (B=1, S=2048,
d_inner 8192, N 16): CUDA events around 20 back-to-back calls, in turns,
the median of 3 turns; and the walk and the finishing sums apart with
torch.profiler. ``kernel`` and the copies that only change a constant
compute the gradient and are held to the plain version first; the
others are instruments:

* ``kernel``: the source as it is;
* ``first_walk_only``: the block returns after the first walk (the
  checkpoints written), before the reverse walk;
* ``no_ckpt``: the first walk writes no checkpoint and the reverse walk
  stages none;
* ``no_dbdc``: no dBm or dCm terms: no rows in shared memory, no sums
  over the channels, no partials (the pair's shuffles may stay);
* ``no_dudt``: du and ddt stored without the butterfly over the
  channel's lanes;
* ``no_finish``: the second kernel (the sums of the partials) not
  launched;
* ``slots8``: eight ring slots instead of four;
* ``walk_no_bc``: the walk back reads no B or C from shared memory (it
  reuses dt and u in their place);
* ``clocks``: lane 0 of every warp reads ``clock64`` at the walk's
  phases; prints each phase's share of the cycles, summed over the
  warps (the marks cost a few percent).

Then the split study: the library's own ``reg`` forward with each split K
(states a thread) forced through its C entry, held to the plain version
and timed in turns the same way, at jamba's prefill (B=8, S=1024; K = 16,
4).

Prints one line per copy and per split and, last, a JSON object of the
times in ms. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import build
from . import ops
from .ref import selective_scan_bwd_ref

SOURCE = ops.CSRC / "selective_scan_reg_bwd.cu"
HEADERS = [ops.CSRC / name for name in (
    "selective_scan.cuh", "selective_scan_reg.cuh", "selective_scan_ptx.cuh")]
KERNELS = ("ssm_bwd_reg<", "ssm_bwd_reg_finish")
#: the clocks copy's timer: lane 0 of each warp adds the cycles since its
#: last mark to the mark's phase (in shared memory) and writes them out at
#: the end: (block, warp, phase) in ``ssm_clk``
CLOCKS = """
__device__ unsigned long long ssm_clk[1 << 17];
__device__ __forceinline__ void clk(int phase) {
  __shared__ unsigned long long last[32], acc[32][8];
  const int w = threadIdx.x / 32;
  if ((threadIdx.x & 31) != 0) return;
  const unsigned long long now = clock64();
  if (phase < 0) {
    for (int k = 0; k < 8; ++k) acc[w][k] = 0;
  } else if (phase < 8) {
    acc[w][phase] += now - last[w];
  } else {
    for (int k = 0; k < 8; ++k)
      ssm_clk[((blockIdx.y * gridDim.x + blockIdx.x) * 32 + w) * 8 + k] =
          acc[w][k];
  }
  last[w] = now;
}
"""
ABLATIONS = {
    "kernel": [],
    "first_walk_only": [
        ("  __syncthreads();  // the ring is free for the reverse walk\n",
         "  __syncthreads();  // the ring is free for the reverse walk\n"
         "  return;\n")],
    "no_ckpt": [
        ("    if (live)\n      ssm_reg::store4<K>(p.ckpt",
         "    if (false)\n      ssm_reg::store4<K>(p.ckpt"),
        ("    if (grads && s < subs - 1)  // the last one's is the first "
         "walk's h",
         "    if (false)")],
    "no_dbdc": [
        ("        ssm_reg::store4<K>(rows + (size_t)tt * G::PAIRS * 2 * N, "
         "keep);",
         "        (void)keep;"),
        ("    if (i >= 1) {\n      const int s1", "    if (false) {\n"
         "      const int s1")],
    "no_dudt": [
        ("    const float du_s = ssm::transpose_sum<L>(vdu, j);\n"
         "    const float ddt_s = ssm::transpose_sum<L>(vddt, j);",
         "    const float du_s = vdu[0], ddt_s = vddt[0];")],
    "no_finish": [
        ("  ssm_bwd_reg_finish<N><<<blocks, 256, 0, stream>>>(\n"
         "      p.part, p.dA_part, dBm, dCm, dA, p.B, p.S, p.D, nblk);",
         "  (void)blocks;")],
    "slots8": [("  static constexpr int SLOTS = 4;",
                "  static constexpr int SLOTS = 8;")],
    "walk_no_bc": [
        ("        ssm_reg::load4<K>(Bv, sB + tt * N + j * K);\n"
         "        ssm_reg::load4<K>(Cv, sC + tt * N + j * K);\n"
         "        float s1",
         "        for (int k = 0; k < K; ++k) {\n          Bv[k] = dtv;\n"
         "          Cv[k] = uv;\n        }\n        float s1")],
    "clocks": [
        ("namespace {\n", "namespace {\n" + CLOCKS),
        ("  const int walks = subs - 1;\n",
         "  clk(-1);\n  const int walks = subs - 1;\n"),
        ("  __syncthreads();  // the ring is free for the reverse walk\n",
         "  __syncthreads();  // the ring is free for the reverse walk\n"
         "  clk(0);\n"),
        ("    __syncthreads();  // sub-tile subs-1-i has landed; the last "
         "rows are in\n",
         "    __syncthreads();  // sub-tile subs-1-i has landed; the last "
         "rows are in\n    clk(1);\n"),
        ("    if (i < subs) {\n      const int s = subs - 1 - i",
         "    clk(2);\n    if (i < subs) {\n      const int s = subs - 1 - i"),
        ("  const bool upper = c & 1;  // the pair's upper channel keeps",
         "  clk(3);\n  const bool upper = c & 1;  // the pair's upper "
         "channel keeps"),
        ("                            live, D);\n      }\n    }\n  }\n",
         "                            live, D);\n      }\n    }\n"
         "    clk(4);\n  }\n"),
        ("  if (live) {\n    ssm_reg::store4<K>(p.dA_part + hidx, dA);",
         "  clk(5);\n  clk(8);\n  if (live) {\n    ssm_reg::store4<K>("
         "p.dA_part + hidx, dA);"),
        ("extern \"C\" int repro_ssm_reg_bwd_steps()",
         "extern \"C\" int ssm_clk_read(unsigned long long* out, int n) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(out, ssm_clk, "
         "n * sizeof(unsigned long long)));\n}\n\n"
         "extern \"C\" int repro_ssm_reg_bwd_steps()")],
}
#: the phases the clocks copy times, in order
CLOCK_PHASES = ("first walk", "wait, barrier", "sum rows",
                "fill, recompute", "walk back", "tail", "-", "-")
#: the copies that compute the gradient
EXACT = ("kernel", "slots8")
SHAPE = dict(B=1, S=2048, d_inner=8192, N=16, a_scale=0.02)
#: (label, B, S, A's factor, the splits to time)
SPLITS = [("forward prefill", 8, 1024, 1.0, (16, 4))]


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in ABLATIONS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"ablation {name}: {old!r} is not once in "
                               f"{SOURCE.name}")
        text = text.replace(old, new)
    return text


def build_variant(name: str):
    """Compile one copy into its own library and bind its entry points;
    returns (entry, ptxas report)."""
    out = build.BUILD_DIR / "ablate_ssm" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE.name).write_text(variant_source(name))
    for h in HEADERS:
        shutil.copy(h, out / h.name)
    so = out / "lib.so"
    res = subprocess.run([build._nvcc(), "-shared", *build.NVCC_FLAGS,
                          "-o", str(so), str(out / SOURCE.name)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on ablation {name}:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.repro_ssm_reg_bwd
    fn.argtypes = ops._REG_BWD_ARGTYPES
    fn.restype = ctypes.c_int
    used, kernel = [], ""
    for line in (res.stdout + res.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "Used" in line and "ILi16E" in kernel:
            used.append(line.split(":", 1)[1].strip())
    return fn, used, lib


def read_clocks(lib, call, blocks: int) -> dict:
    """One call of the clocks copy; each phase's share of the cycles its
    warps' lane 0 counted, summed over the warps."""
    import numpy as np
    call(lib.repro_ssm_reg_bwd)
    torch.cuda.synchronize()
    n = blocks * 32 * 8
    buf = (ctypes.c_ulonglong * n)()
    fn = lib.ssm_clk_read
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if fn(ctypes.addressof(buf), n) != 0:
        raise RuntimeError("ssm_clk_read failed")
    cyc = np.array(buf, dtype=np.float64).reshape(blocks, 32, 8)
    total = cyc.sum()
    shares = {ph: float(cyc[:, :, i].sum() / total)
              for i, ph in enumerate(CLOCK_PHASES)}
    warps = int((cyc.sum(2) > 0).sum())
    per_warp = total / max(warps, 1)
    print(f"clocks: {warps} warps, {per_warp:.0f} cycles a warp; "
          + ", ".join(f"{ph} {v:.1%}" for ph, v in shares.items()))
    return shares


def _inputs(B, S, di, N, a_scale, seed=0):
    """(u, dt, Bm, Cm, A, None, dy, dh) at the model's scales."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    dt = torch.nn.functional.softplus(0.5 * rnd(B, S, di)
                                      + math.log(math.e - 1))
    A = -a_scale * torch.arange(1, N + 1, device="cuda",
                                dtype=torch.float32)[None].repeat(di, 1)
    return (rnd(B, S, di), dt, rnd(B, S, N), rnd(B, S, N), A, None,
            rnd(B, S, di), rnd(B, di, N))


def _bwd_outs(B, S, di, N, nblk):
    f32 = dict(dtype=torch.float32, device="cuda")
    return [torch.empty((B, S, di), **f32), torch.empty((B, S, di), **f32),
            torch.empty((B, S, nblk, 2 * N), **f32),
            torch.empty((B, di, N), **f32), torch.empty((B, S, N), **f32),
            torch.empty((B, S, N), **f32), torch.empty((di, N), **f32),
            torch.empty((B, di, N), **f32),
            torch.empty((B, -(-S // 8), di, N), **f32)]


def _ms(call, reps: int = 20) -> float:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _check(label, got, want, gate) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        err = float((a - b).abs().max()) / float(b.abs().max())
        if not err <= gate:
            raise AssertionError(f"{label} disagrees with the plain version:"
                                 f" output {i}, {err}")


def split_study(stream) -> dict:
    """The library's reg forward at each split of SPLITS, in turns."""
    from .ref import selective_scan_ref
    lib = ops.load()
    times = {}
    for label, B, S, a_scale, splits in SPLITS:
        di, N = SHAPE["d_inner"], SHAPE["N"]
        ins = _inputs(B, S, di, N, a_scale, seed=1)[:6]
        calls = {}
        for K in splits:
            outs = [torch.empty_like(ins[0]),
                    torch.empty((B, di, N), device="cuda")]

            def call(K=K, outs=outs):
                err = lib.repro_ssm_reg_fwd(
                    *(None if t is None else t.data_ptr() for t in ins),
                    *(t.data_ptr() for t in outs), B, S, di, N, K, stream)
                if err:
                    raise RuntimeError(f"launch failed ({err})")
            call()
            _check(f"{label} K={K}", outs, selective_scan_ref(*ins), 1e-5)
            calls[K] = call
        runs = {K: [] for K in calls}
        for _ in range(3):
            for K, call in calls.items():
                runs[K].append(_ms(call))
        times[label] = {K: statistics.median(r) for K, r in runs.items()}
        print(f"split {label} (B={B}, S={S}): " + ", ".join(
            f"K={K} {t:.4f} ms" for K, t in times[label].items()))
        del ins, calls
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate: no CUDA card", file=sys.stderr)
        return 2
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:
        built = dict(zip(ABLATIONS, pool.map(build_variant, ABLATIONS)))
    B, S, di, N, a_scale = SHAPE.values()
    ins = _inputs(B, S, di, N, a_scale)
    outs = _bwd_outs(B, S, di, N,
                     -(-di // ops.load().repro_ssm_reg_bwd_channels(N)))
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn) -> None:
        err = fn(*(None if t is None else t.data_ptr() for t in ins),
                 *(t.data_ptr() for t in outs), B, S, di, N, stream)
        if err != 0:
            raise RuntimeError(f"launch failed ({err})")

    want = selective_scan_bwd_ref(*ins)
    for name in EXACT:
        call(built[name][0])
        _check(f"copy {name}", [outs[i] for i in (0, 1, 4, 5, 6, 7)], want,
               3e-5)
    del want

    def by_kernel(fn, calls: int = 5) -> dict:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call(fn)
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        return {name.strip("<"): sum(e.self_device_time_total for e in evs
                                     if name in e.key) / 1e3 / calls
                for name in KERNELS}

    runs = {name: [] for name in built}
    for _ in range(3):
        for name, (fn, _, _) in built.items():
            runs[name].append(_ms(lambda fn=fn: call(fn)))
    clocks = read_clocks(built["clocks"][2], call,
                         B * -(-di // (256 // (N // 4))))
    times = {}
    for name, (fn, used, _) in built.items():
        split = by_kernel(fn)
        times[name] = {"call": statistics.median(runs[name]), **split}
        print(f"ablate {name:16s} {times[name]['call']:.4f} ms a call; "
              + ", ".join(f"{k} {t:.4f}" for k, t in split.items())
              + f"; ptxas {used}")
    del ins, outs
    splits = split_study(stream)
    print(json.dumps({"ablate_ms": times, "clock_shares": clocks,
                      "split_ms": splits, "shape": SHAPE,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
