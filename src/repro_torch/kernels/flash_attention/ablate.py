"""Ablations of the sm90 flash-attention kernel on the card: where its
time goes.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablate \
        [--shape granite-8b|gemma3-1b]

Builds copies of ``csrc/flash_attention_sm90.cu``, each with one part
taken out or changed by a text substitution (a substitution that does
not find its text fails the run), into ``build/repro_torch_kernels/
ablate/``, one ``nvcc`` each, in parallel. Then times every copy in
turns at the shape set's cases: CUDA events around back-to-back calls
of the C entry point (no wrapper, so no host time between launches),
median of 3 turns. ``granite-8b`` (the default): its prefill shape
(B=8, S=1024, H=32, KV=8, hd=128, bf16), causal and not. ``gemma3-1b``:
hd 256, its prefill (B=8, S=1024, H=4, KV=1) and training (B=1, S=2048)
shapes, causal, at window 1024 (its local layers) and none (its global
ones). Only ``kernel`` and ``serial`` compute attention (each is held
to the plain version first); the others are instruments:

* ``kernel``: the source as it is;
* ``serial``: each consumer waits for S of tile t and the PV product of
  tile t - 1 together, so its softmax no longer overlaps that PV;
* ``no_p_lo``: without the P_lo product, i.e. P rounded once to bf16
  (at v widths 64 and 128; at 256 it changes nothing);
* ``stages_2``, ``stages_3``: a K/V ring of 2 or 3 slots, not 4 (at hd
  256 the ring has 2 at most);
* ``loads_only``: the consumers wait for and release every K/V tile
  without computing: the TMA traffic, the barriers and the epilogue.

Prints one line per copy and case and, last, a JSON object of the times
in ms. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
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
    "serial": [("wgmma_wait<1>();                    // S done, PV may run "
                "on", "wgmma_wait<0>();")],
    "no_p_lo": [("wgmma_rs_m64n64k16(o, lo[kk], dv);", ""),
                ("wgmma_rs_m64n128k16(o, lo[kk], dv);", "")],
    "stages_2": [("MAX_STAGES = 4;", "MAX_STAGES = 2;")],
    "stages_3": [("MAX_STAGES = 4;", "MAX_STAGES = 3;")],
    "loads_only": [("    if (t_hi > t_lo) {\n",
                    "    for (int t = t_lo; t < t_hi; ++t) skip();\n"
                    "    if (false) {\n")],
}
#: the cases of each shape set: (label, B, S, H, KV, hd, causal, window)
SHAPES = {
    "granite-8b": [("causal", 8, 1024, 32, 8, 128, 1, 0),
                   ("full", 8, 1024, 32, 8, 128, 0, 0)],
    "gemma3-1b": [("prefill", 8, 1024, 4, 1, 256, 1, 1024),
                  ("prefill global", 8, 1024, 4, 1, 256, 1, 0),
                  ("train", 1, 2048, 4, 1, 256, 1, 1024),
                  ("train global", 1, 2048, 4, 1, 256, 1, 0)],
}
#: the copies that compute attention (the others are instruments)
COMPUTES = ("kernel", "serial")


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
    fn.argtypes = ops._SM90_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="granite-8b")
    shape = ap.parse_args(argv).shape
    if not torch.cuda.is_available():
        print("ablate: no CUDA card", file=sys.stderr)
        return 2
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:
        fns = dict(zip(ABLATIONS, pool.map(build_variant, ABLATIONS)))
    stream = torch.cuda.current_stream().cuda_stream
    times = {name: {} for name in fns}
    for label, B, S, H, KV, hd, causal, window in SHAPES[shape]:
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn((B, S, H, hd), generator=g, device="cuda").bfloat16()
        k = torch.randn((B, S, KV, hd), generator=g, device="cuda").bfloat16()
        v = torch.randn((B, S, KV, hd), generator=g, device="cuda").bfloat16()
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")

        def call(fn) -> None:
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), B, H, KV, S, S, hd, hd,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *out.stride()[:3], 1.0 / math.sqrt(hd), causal, window,
                     0, 0.0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed ({err})")

        kw = dict(causal=bool(causal), window=window or None)
        plain = flash_attention_ref(q, k, v, **kw)
        for name in COMPUTES:
            call(fns[name])
            err = (out.float() - plain.float()).abs().max().item()
            if not err <= 5e-2:
                raise AssertionError(f"the {name} copy disagrees with the "
                                     f"plain version at {label}: max "
                                     f"|diff| {err}")
        del plain

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

        runs = {name: [] for name in fns}
        for _ in range(3):
            for name, fn in fns.items():
                runs[name].append(ms(fn))
        qp = torch.arange(S)
        lo = (qp - window + 1).clamp(min=0) if window else 0 * qp
        hi = qp + 1 if causal else torch.full_like(qp, S)
        flops = 4 * B * H * hd * int((hi - lo).sum())
        for name in fns:
            t = statistics.median(runs[name])
            times[name][label] = t
            print(f"ablate {name:10s} {label:14s} {t:.4f} ms "
                  f"({flops / t / 1e9:.1f} TFLOP/s counted on the "
                  f"attention's {flops / 1e9:.2f} GFLOP)")
    print(json.dumps({"ablate_ms": times, "shape": shape,
                      "cases": SHAPES[shape],
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
