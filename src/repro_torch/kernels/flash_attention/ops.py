"""Public wrapper around the CUDA flash-attention kernels.

Two kernels, one library: ``csrc/flash_attention_sm90.cu`` (bf16 at the
head dims in :data:`SM90_HEAD_DIMS`: wgmma, TMA, warp-specialised) and
``csrc/flash_attention.cu`` (float32 FMAs: float32, and bf16 at the other
head dims). :func:`select_variant` picks one from (dtype, head dim) alone.
The library is built with ``nvcc`` at the first call on a CUDA tensor and
bound through ``ctypes``; see :mod:`repro_torch.kernels.build`. Nothing
is built at import.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..build import load_library
from .ref import flash_attention_ref

CSRC = Path(__file__).resolve().parent / "csrc"
#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
#: bf16 head dims the Hopper kernel takes (at hd 256 two Q buffers would
#: leave shared memory for one K/V slot, and O alone would take 128
#: accumulator registers of a thread)
SM90_HEAD_DIMS = (64, 128)
#: the kernels: ``sm90`` in flash_attention_sm90.cu, ``fma`` in
#: flash_attention.cu
VARIANTS = ("sm90", "fma")
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
        sm90 = lib.repro_flash_attention_sm90_fwd
        sm90.argtypes = _ARGTYPES[:4] + _ARGTYPES[5:]   # no dtype code
        sm90.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def select_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches:
    ``sm90`` for bf16 at :data:`SM90_HEAD_DIMS`, else ``fma``."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    return "fma"


def check_tma_layout(**tensors: torch.Tensor) -> None:
    """TMA's rules for the ``sm90`` kernel's tensors: a 16-byte aligned
    base and every stride but the head dim's a multiple of 16 bytes.
    Raises ValueError naming the first tensor that breaks one."""
    for name, t in tensors.items():
        size = t.element_size()
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention (sm90): {name} starts at "
                             f"{t.data_ptr():#x}, not 16-byte aligned, as "
                             f"TMA needs")
        bad = [s for s in t.stride()[:-1] if (s * size) % 16]
        if bad:
            raise ValueError(f"flash_attention (sm90): {name} strides "
                             f"{tuple(t.stride())} (elements of {size} "
                             f"bytes) are not all multiples of 16 bytes, "
                             f"as TMA needs")


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

    A CUDA tensor launches one kernel on the current stream, the one
    :func:`select_variant` names (float32 or bfloat16, hd in
    :data:`HEAD_DIMS`), and adds one to ``flash_attention.launches`` and
    to ``flash_attention.variant_launches[variant]``; anything it cannot
    take raises (the ``sm90`` kernel's tensors must also meet
    :func:`check_tma_layout`), and a failed launch raises. A CPU tensor
    runs the plain version :func:`flash_attention_ref`, which is not
    counted.

    Two quirks of the reference, documented and not copied:

    * The reference's Pallas dispatch (``repro.models.layers.
      multi_head_attention``) passes neither ``q_offset`` nor
      ``softcap`` to its kernel, so there a prompt continued at an
      offset, or a soft-capped model, silently gets other scores. Here
      both reach the kernel.
    * The Pallas kernel masks with a finite ``NEG_INF = -1e30`` and the
      reference's plain path with ``-inf``; the two agree only because a
      fully masked row is zeroed in both (``acc / max(l, 1e-30)`` there,
      NaN → 0 after the softmax here). The ``fma`` kernel keeps the
      finite sentinel for its running max and zeroes masked
      probabilities explicitly; the ``sm90`` kernel masks with ``-inf``
      and takes 0 as the max of a row that has seen no key yet.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, softcap=softcap)
    return run_variant(select_variant(q.dtype, q.shape[-1]), q, k, v,
                       causal=causal, window=window, q_offset=q_offset,
                       softcap=softcap)


def run_variant(variant: str, q, k, v, *, causal: bool = True,
                window: int | None = None, q_offset: int = 0,
                softcap: float = 0.0) -> torch.Tensor:
    """Launch the named kernel on CUDA tensors and count it.
    :func:`flash_attention` calls it with the variant
    :func:`select_variant` names; ``chip_smoke.py`` also calls it to time
    the ``fma`` kernel at a bf16 shape the ``sm90`` kernel takes."""
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if variant not in VARIANTS:
        raise ValueError(f"unknown flash_attention variant {variant!r}")
    if variant == "sm90" and select_variant(q.dtype, hd) != "sm90":
        raise ValueError(f"the sm90 kernel takes bfloat16 at head dims "
                         f"{SM90_HEAD_DIMS}, not {q.dtype} at {hd}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernels run on cuda, not "
                         f"{q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous head dim")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if variant == "sm90":
        check_tma_layout(q=q, k=k, v=v)
    lib = load()
    args = (B, H, KV, Sq, Sk, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], 1.0 / math.sqrt(hd),
            int(causal), int(window or 0), int(q_offset), float(softcap))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant == "sm90":
            err = lib.repro_flash_attention_sm90_fwd(*ptrs, *args, stream)
        else:
            err = lib.repro_flash_attention_fwd(*ptrs, _DTYPE_CODE[q.dtype],
                                                *args, stream)
    if err < 0:
        raise RuntimeError(f"flash_attention ({variant}): a TMA tensor map "
                           f"could not be encoded (CUresult {-err})")
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention ({variant}) launch failed: "
                           f"{msg} (cudaError {err})")
    flash_attention.launches += 1
    flash_attention.variant_launches[variant] += 1
    return out


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)

__all__ = ["HEAD_DIMS", "SM90_HEAD_DIMS", "VARIANTS", "check_tma_layout",
           "flash_attention", "flash_attention_ref", "load", "run_variant",
           "select_variant"]
