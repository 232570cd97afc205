"""Ablations of the sm90 flash-attention kernel on the card: where its
time goes.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablate

Builds copies of ``csrc/flash_attention_sm90.cu``, each with one part
taken out or changed by a text substitution (a substitution that does
not find its text fails the run), into ``build/repro_torch_kernels/
ablate/``, one ``nvcc`` each, in parallel. Then times every copy at the
granite-8b prefill shape (B=8, S=1024, H=32, KV=8, hd=128, bf16), causal
and not, in turns: CUDA events around back-to-back launches, median of
3 turns. Only ``kernel`` computes attention (it is held to the plain
version first); the others are instruments:

* ``kernel``: the source as it is;
* ``no_p_lo``: without the P_lo product, i.e. P rounded once to bf16;
* ``stages_2``, ``stages_3``: a K/V ring of 2 or 3 slots, not 4;
* ``loads_only``: the consumers wait for and release every K/V tile
  without computing: the TMA traffic, the barriers and the epilogue.

Prints one line per copy and, last, a JSON object of the times in ms.
Needs a CUDA card and ``nvcc``.
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
from .ref import flash_attention_ref

SOURCE = ops.CSRC / "flash_attention_sm90.cu"
HEADER = ops.CSRC / "sm90_ptx.cuh"
ABLATIONS = {
    "kernel": [],
    "no_p_lo": [("wgmma_rs_m64n64k16(o, lo[kk], dv);", ""),
                ("wgmma_rs_m64n128k16(o, lo[kk], dv);", "")],
    "stages_2": [("MAX_STAGES = 4;", "MAX_STAGES = 2;")],
    "stages_3": [("MAX_STAGES = 4;", "MAX_STAGES = 3;")],
    "loads_only": [("    if (t_hi > t_lo) {\n",
                    "    for (int t = t_lo; t < t_hi; ++t) skip();\n"
                    "    if (false) {\n")],
}
SHAPE = dict(B=8, S=1024, H=32, KV=8, hd=128)


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in ABLATIONS[name]:
        if old not in text:
            raise RuntimeError(f"ablation {name}: {old!r} is not in "
                               f"{SOURCE.name}")
        text = text.replace(old, new)
    return text


def build_variant(name: str) -> ctypes.CDLL:
    """Compile one copy into its own library and bind its entry point."""
    out = build.BUILD_DIR / "ablate" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE.name).write_text(variant_source(name))
    shutil.copy(HEADER, out / HEADER.name)
    so = out / "lib.so"
    res = subprocess.run([build._nvcc(), "-shared", *build.NVCC_FLAGS,
                          "-o", str(so), str(out / SOURCE.name)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on ablation {name}:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.repro_flash_attention_sm90_fwd
    fn.argtypes = ops._ARGTYPES[:5] + ops._ARGTYPES[6:]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate: no CUDA card", file=sys.stderr)
        return 2
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:
        fns = dict(zip(ABLATIONS, pool.map(build_variant, ABLATIONS)))
    B, S, H, KV, hd = (SHAPE[k] for k in ("B", "S", "H", "KV", "hd"))
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, S, KV, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, S, KV, hd), generator=g, device="cuda").bfloat16()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, causal: int) -> None:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, H, KV, S, S, hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out.stride()[:3], 1.0 / math.sqrt(hd),
                 causal, 0, 0, 0.0, stream)
        if err != 0:
            raise RuntimeError(f"launch failed ({err})")

    call(fns["kernel"], 1)
    plain = flash_attention_ref(q, k, v, causal=True)
    err = (out.float() - plain.float()).abs().max().item()
    if not err <= 5e-2:
        raise AssertionError(f"the kernel copy disagrees with the plain "
                             f"version: max |diff| {err}")

    def ms(fn, causal: int, reps: int = 20) -> float:
        for _ in range(3):
            call(fn, causal)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call(fn, causal)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    runs = {(name, causal): [] for name in fns for causal in (1, 0)}
    for _ in range(3):
        for name, fn in fns.items():
            for causal in (1, 0):
                runs[name, causal].append(ms(fn, causal))
    flops = {1: 4 * B * H * hd * S * (S + 1) // 2, 0: 4 * B * H * hd * S * S}
    times = {}
    for name in fns:
        times[name] = {}
        for causal, label in ((1, "causal"), (0, "full")):
            t = statistics.median(runs[name, causal])
            times[name][label] = t
            print(f"ablate {name:10s} {label:6s} {t:.4f} ms "
                  f"({flops[causal] / t / 1e9:.1f} TFLOP/s counted on the "
                  f"attention's {flops[causal] / 1e9:.2f} GFLOP)")
    print(json.dumps({"ablate_ms": times, "shape": SHAPE,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
