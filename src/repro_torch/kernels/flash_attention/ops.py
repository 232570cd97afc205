"""Public wrapper around the CUDA flash-attention kernel.

The kernel (``csrc/flash_attention.cu``) is built with ``nvcc`` at the
first call on a CUDA tensor and bound through ``ctypes``; see
:mod:`repro_torch.kernels.build`. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..build import load_library
from .ref import flash_attention_ref

CSRC = Path(__file__).resolve().parent / "csrc"
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_c_ll = ctypes.c_longlong
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [_c_ll] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p])


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; sets the C
    signatures."""
    lib = load_library("flash_attention", CSRC)
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects q (B,Sq,H,hd) and k, v "
                         "(B,Sk,KV,hd)")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"num_heads {H} is not a multiple of "
                         f"num_kv_heads {k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{sorted(map(str, _DTYPE_CODE))}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention forward. q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), the
    model's layout, read through strides (the head dim must be
    contiguous). Returns (B, Sq, H, hd) in q's dtype.

    GQA: head h reads KV head h // (H // KV). ``q_offset`` is the
    absolute position of q[:, 0] for the causal and window masks;
    ``softcap`` > 0 applies ``tanh(s / softcap) * softcap`` to the scaled
    scores before the mask. Rows with every key masked give 0.

    A CUDA tensor launches the kernel (float32 or bfloat16, hd in
    :data:`HEAD_DIMS`) on the current stream and adds one to
    ``flash_attention.launches``; anything it cannot take raises. A CPU
    tensor runs the plain version :func:`flash_attention_ref`, which is
    not counted.

    Two quirks of the reference, documented and not copied:

    * The reference's Pallas dispatch (``repro.models.layers.
      multi_head_attention``) passes neither ``q_offset`` nor
      ``softcap`` to its kernel, so there a prompt continued at an
      offset, or a soft-capped model, silently gets other scores. Here
      both reach the kernel.
    * The Pallas kernel masks with a finite ``NEG_INF = -1e30`` and the
      reference's plain path with ``-inf``; the two agree only because a
      fully masked row is zeroed in both (``acc / max(l, 1e-30)`` there,
      NaN → 0 after the softmax here). This kernel keeps the finite
      sentinel for its running max and zeroes masked probabilities
      explicitly.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous head dim")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, KV, Sq, Sk, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], 1.0 / math.sqrt(hd), int(causal),
            int(window or 0), int(q_offset), float(softcap), stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} "
                           f"(cudaError {err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_ref", "load"]
