"""Public wrappers around the CUDA flash-attention kernels, forward and
backward, and the PyTorch custom ops they go through.

Five kernels, one library: ``csrc/flash_attention_sm90.cu`` (forward,
bf16 at the (q/k head dim, v width) pairs in :data:`SM90_SHAPES`: wgmma,
TMA, warp-specialised), ``csrc/flash_attention.cu`` (forward, float32
FMAs: float32, and bf16 at the other shapes),
``csrc/flash_attention_bwd_sm90.cu`` (backward, bf16 at
:data:`SM90_SHAPES`: wgmma, TMA, warp-specialised, the forward's LSE),
``csrc/flash_attention_bwd_mma.cu`` (backward, bf16 at
:data:`MMA_BWD_HEAD_DIMS` with v as wide as q: mma.sync tensor cores;
the earlier design, kept to compare) and ``csrc/flash_attention_bwd.cu``
(backward, float32 FMAs, every dtype and head dim). :func:`select_variant`
picks the forward and :func:`select_bwd_variant` the backward from
(dtype, head dim, v width) alone.

v may be narrower than q and k (MLA: q/k 192, v 128). The sm90 kernels
read it at its own width. The fma kernels take one width for all three:
their wrappers zero-pad v (and dO) to the head dim and slice the output
(and dv) back, which is those kernels' input convention.

The library is built with ``nvcc`` at the first call on a CUDA tensor
and bound through ``ctypes``; see :mod:`repro_torch.kernels.build`.
Nothing is built at import.

Both directions are PyTorch custom ops, ``repro_torch::flash_attention``
(which returns the output and each row's log-sum-exp) and
``repro_torch::flash_attention_bwd`` (which takes that LSE after the
output): a CUDA implementation that
launches the kernels, a CPU implementation that runs the plain versions
(:mod:`.ref`), a fake implementation (so that ``make_fx`` traces them on
fake tensors of either device, as one node each) and, on the forward,
an autograd formula that calls the backward op. A training step
differentiated with ``torch.autograd`` therefore runs the backward
kernel on the card, and its trace holds one forward and one backward
node per attention layer.
"""
import ctypes
import math
from pathlib import Path

import torch

from ..build import load_library
from .ref import flash_attention_bwd_ref, flash_attention_ref

CSRC = Path(__file__).resolve().parent / "csrc"
#: head dims the fma kernels are instantiated for (192: MLA's nope +
#: rope, deepseek-v2-lite's training branch)
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192, 256)
#: the bf16 (q/k head dim, v width) pairs the Hopper kernels are
#: instantiated for: (192, 128) is deepseek-v2-lite's MLA training branch
#: (128 nope + 64 rope, v 128), (256, 256) gemma3-1b, (80, 80)
#: hubert-xlarge (five 16-column boxes in 32-byte swizzle). Another pair
#: joins here with an instantiation of both sm90 kernels; until then it
#: runs fma.
SM90_SHAPES = ((64, 64), (80, 80), (128, 128), (192, 128), (256, 256))
#: the forward kernels: ``sm90`` in flash_attention_sm90.cu, ``fma`` in
#: flash_attention.cu
VARIANTS = ("sm90", "fma")
#: the backward kernels: ``sm90`` in flash_attention_bwd_sm90.cu (bf16 at
#: :data:`SM90_SHAPES`: wgmma, TMA, the forward's LSE), ``mma`` in
#: flash_attention_bwd_mma.cu (bf16 at :data:`MMA_BWD_HEAD_DIMS`,
#: mma.sync; the earlier design), ``fma`` in flash_attention_bwd.cu (every
#: dtype and head dim)
BWD_VARIANTS = ("sm90", "mma", "fma")
MMA_BWD_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: rows of the sm90 backward's statistics scratch are padded to a multiple
#: of this, so that its tiles read them whole
SM90_BWD_PAD = 128

_c_ll = ctypes.c_longlong
# q, k, v, out and lse; dtype and the sizes; four stride triples
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [_c_ll] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p])
# the sm90 forward: no dtype code; the sizes with v's width after hd
_SM90_ARGTYPES = _ARGTYPES[:5] + [ctypes.c_int] * 7 + _ARGTYPES[12:]
# eight tensors, lse and delta; dtype and the sizes; eight stride triples
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [_c_ll] * 24
                 + _ARGTYPES[-6:])
# q, k, v, out, dout, the forward's lse, dq, dk, dv and four scratch
# tensors; the sizes (v's width after hd) and the padded row count; eight
# stride triples
_SM90_BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
                      + [_c_ll] * 24 + _ARGTYPES[-6:])


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; sets the C
    signatures."""
    lib = load_library("flash_attention", CSRC)
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        sm90 = lib.repro_flash_attention_sm90_fwd
        sm90.argtypes = _SM90_ARGTYPES
        sm90.restype = ctypes.c_int
        lib.repro_flash_attention_bwd.argtypes = _BWD_ARGTYPES
        lib.repro_flash_attention_bwd.restype = ctypes.c_int
        mma = lib.repro_flash_attention_bwd_mma
        mma.argtypes = _BWD_ARGTYPES[:10] + _BWD_ARGTYPES[11:]  # no dtype
        mma.restype = ctypes.c_int
        bwd90 = lib.repro_flash_attention_bwd_sm90
        bwd90.argtypes = _SM90_BWD_ARGTYPES
        bwd90.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def select_bwd_variant(dtype: torch.dtype, head_dim: int,
                       v_dim: int | None = None) -> str:
    """The backward kernel a CUDA call of this dtype, q/k head dim and v
    width (default: the head dim) launches: ``sm90`` for bf16 at
    :data:`SM90_SHAPES`, else ``fma`` (``mma`` is launched only by name,
    through :func:`run_bwd_variant`)."""
    return select_variant(dtype, head_dim, v_dim)


def select_variant(dtype: torch.dtype, head_dim: int,
                   v_dim: int | None = None) -> str:
    """The forward kernel a CUDA call of this dtype, q/k head dim and v
    width (default: the head dim) launches: ``sm90`` for bf16 at
    :data:`SM90_SHAPES`, else ``fma``."""
    shape = (head_dim, head_dim if v_dim is None else v_dim)
    if dtype == torch.bfloat16 and shape in SM90_SHAPES:
        return "sm90"
    return "fma"


def _check_16_bytes(kernel: str, why: str, tensors: dict) -> None:
    """A 16-byte aligned base and every stride but the head dim's a
    multiple of 16 bytes, for each tensor; raises ValueError naming the
    first that breaks one."""
    for name, t in tensors.items():
        size = t.element_size()
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} starts at "
                             f"{t.data_ptr():#x}, not 16-byte aligned, "
                             f"{why}")
        bad = [s for s in t.stride()[:-1] if (s * size) % 16]
        if bad:
            raise ValueError(f"{kernel}: {name} strides "
                             f"{tuple(t.stride())} (elements of {size} "
                             f"bytes) are not all multiples of 16 bytes, "
                             f"{why}")


def check_tma_layout(**tensors: torch.Tensor) -> None:
    """TMA's rules for the ``sm90`` kernel's tensors: a 16-byte aligned
    base and every stride but the head dim's a multiple of 16 bytes.
    Raises ValueError naming the first tensor that breaks one."""
    _check_16_bytes("flash_attention (sm90)", "as TMA needs", tensors)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects q (B,Sq,H,hd), k "
                         "(B,Sk,KV,hd) and v (B,Sk,KV,dv)")
    B, _, H, hd = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != hd:
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


def _check_window(window) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0,
                    softcap: float = 0.0, return_lse: bool = False):
    """Attention forward. q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B,
    Sk, KV, dv), dv the v width (MLA's is narrower than q and k), the
    model's layout, read through strides (the head dim must be
    contiguous). Returns (B, Sq, H, dv) in q's dtype; with
    ``return_lse`` also each row's log-sum-exp over its scaled
    (soft-capped) visible scores, float32 (B, H, Sq), +inf for a row
    with every key masked: what :func:`flash_attention_bwd` takes.

    GQA: head h reads KV head h // (H // KV). ``q_offset`` is the
    absolute position of q[:, 0] for the causal and window masks;
    ``softcap`` > 0 applies ``tanh(s / softcap) * softcap`` to the scaled
    scores before the mask. Rows with every key masked give 0.

    It runs the custom op ``repro_torch::flash_attention``, which is
    differentiable: its gradient is :func:`flash_attention_bwd`. A CUDA
    tensor launches one kernel on the current stream, the one
    :func:`select_variant` names (float32 or bfloat16; hd in
    :data:`HEAD_DIMS` and dv <= hd, or a pair of :data:`SM90_SHAPES`),
    and adds one to ``flash_attention.launches`` and
    to ``flash_attention.variant_launches[variant]``; anything it cannot
    take raises (the ``sm90`` kernel's tensors must also meet
    :func:`check_tma_layout`), and a failed launch raises. A CPU tensor
    runs the plain version :func:`flash_attention_ref`, which is not
    counted. Inside a captured CUDA graph the counts move at capture,
    not at replay.

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
    _check_window(window)
    out, lse = _fwd_op(q, k, v, bool(causal), int(window or 0),
                       int(q_offset), float(softcap))
    return (out, lse) if return_lse else out


def run_variant(variant: str, q, k, v, *, causal: bool = True,
                window: int | None = None, q_offset: int = 0,
                softcap: float = 0.0):
    """Launch the named kernel on CUDA tensors and count it; returns the
    output and its rows' LSE (both kernels write it), as the forward op
    does. :func:`flash_attention` calls it with the variant
    :func:`select_variant` names; ``chip_smoke.py`` also calls it to time
    the ``fma`` kernel at a bf16 shape the ``sm90`` kernel takes. The
    ``fma`` kernel takes v at the head dim: v narrower than that is
    zero-padded to it here and the output sliced back (a copy)."""
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    if variant not in VARIANTS:
        raise ValueError(f"unknown flash_attention variant {variant!r}")
    if variant == "sm90" and select_variant(q.dtype, hd, dv) != "sm90":
        raise ValueError(f"the sm90 kernel takes bfloat16 at (head dim, v "
                         f"width) {SM90_SHAPES}, not {q.dtype} at "
                         f"{(hd, dv)}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernels run on cuda, not "
                         f"{q.device}")
    if hd not in HEAD_DIMS or dv > hd:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS} "
                         f"or v width {dv} above it")
    _check_window(window)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous head dim")
    if variant == "fma" and dv < hd:
        out, lse = run_variant("fma", q, k, _pad_to(v, hd), causal=causal,
                               window=window, q_offset=q_offset,
                               softcap=softcap)
        return out[..., :dv].contiguous(), lse
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    if variant == "sm90":
        check_tma_layout(q=q, k=k, v=v)
    lib = load()
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3], 1.0 / math.sqrt(hd), int(causal),
               int(window or 0), int(q_offset), float(softcap))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant == "sm90":
            err = lib.repro_flash_attention_sm90_fwd(
                *ptrs, B, H, KV, Sq, Sk, hd, dv, *strides, stream)
        else:
            err = lib.repro_flash_attention_fwd(
                *ptrs, _DTYPE_CODE[q.dtype], B, H, KV, Sq, Sk, hd, *strides,
                stream)
    if err < 0:
        raise RuntimeError(f"flash_attention ({variant}): a TMA tensor map "
                           f"could not be encoded (CUresult {-err})")
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention ({variant}) launch failed: "
                           f"{msg} (cudaError {err})")
    flash_attention.launches += 1
    flash_attention.variant_launches[variant] += 1
    return out, lse


def flash_attention_bwd(dout, q, k, v, out, lse, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        softcap: float = 0.0):
    """Gradient of :func:`flash_attention`: (dq, dk, dv) for the
    cotangent ``dout`` of its output ``out`` at (q, k, v), each in its
    input's shape and dtype (q: (B, Sq, H, hd); dout, out: (B, Sq, H,
    dv); k: (B, Sk, KV, hd); v: (B, Sk, KV, dv), read through strides
    with a contiguous head dim). ``lse`` is
    the forward's float32 (B, H, Sq) row log-sum-exp
    (``flash_attention(..., return_lse=True)``), which the ``sm90`` kernel
    reads. A row whose every key is masked gets zero gradients.

    It runs the custom op ``repro_torch::flash_attention_bwd``. A CUDA
    tensor launches the backward kernel that :func:`select_bwd_variant`
    names (a few kernels in stream order, float32 accumulation, no
    atomics, so repeated calls are bit-equal) on the current stream and
    adds one to ``flash_attention_bwd.launches`` and to
    ``flash_attention_bwd.variant_launches[variant]``; anything it cannot
    take raises (the ``sm90`` and ``mma`` kernels' q, k, v, out and dout
    must also have 16-byte aligned bases and strides), and a failed
    launch raises. A CPU tensor runs the plain version
    :func:`flash_attention_bwd_ref`, which is not counted."""
    _check(q, k, v)
    _check_window(window)
    want = (*q.shape[:3], v.shape[3])
    if dout.shape != want or out.shape != want:
        raise ValueError(f"dout {tuple(dout.shape)} and out "
                         f"{tuple(out.shape)} must have the forward "
                         f"output's shape {want}")
    if dout.dtype != q.dtype or out.dtype != q.dtype:
        raise TypeError(f"dout ({dout.dtype}) and out ({out.dtype}) must "
                        f"have q's dtype {q.dtype}")
    _check_lse(lse, q)
    return _bwd_op(dout, q, k, v, out, lse, bool(causal), int(window or 0),
                   int(q_offset), float(softcap))


def _pad_to(t, width: int):
    """``t`` zero-padded in its last dim to ``width`` (itself if it is
    that wide): the fma kernels' one head dim for q, k, v, out and dO."""
    pad = width - t.shape[-1]
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _check_lse(lse, q) -> None:
    """The forward's LSE: float32 (B, H, Sq) on q's device."""
    B, Sq, H, _ = q.shape
    if not isinstance(lse, torch.Tensor) or lse.shape != (B, H, Sq) or \
            lse.dtype != torch.float32 or lse.device != q.device:
        got = (f"{lse.dtype} {tuple(lse.shape)} on {lse.device}"
               if isinstance(lse, torch.Tensor) else type(lse).__name__)
        raise ValueError(f"lse must be the forward's float32 (B, H, Sq) = "
                         f"{(B, H, Sq)} on {q.device} (flash_attention(..., "
                         f"return_lse=True)); got {got}")


def run_bwd_variant(variant: str, dout, q, k, v, out, lse, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, softcap: float = 0.0):
    """Launch the named backward kernel on CUDA tensors and count it, as
    :func:`flash_attention_bwd` does with the variant
    :func:`select_bwd_variant` names; ``chip_smoke.py`` calls it to hold
    and time the earlier kernels (``mma``, ``fma``) at bf16 shapes the
    ``sm90`` kernel takes. ``sm90`` reads ``lse``; the others compute
    their own and ignore it. ``fma`` takes v at the head dim: v, dout and
    out narrower than that are zero-padded to it here and dv sliced back
    (a copy)."""
    _check(q, k, v)
    _check_window(window)
    _check_lse(lse, q)
    return _launch_bwd(variant, dout, q, k, v, out, lse, causal, window or 0,
                       q_offset, softcap)


def _launch_bwd(variant, dout, q, k, v, out, lse, causal, window, q_offset,
                softcap):
    """The named backward kernel's checks, then its launch."""
    if variant not in BWD_VARIANTS:
        raise ValueError(f"unknown flash_attention_bwd variant {variant!r}")
    B, Sq, H, hd = q.shape
    dvw = v.shape[3]
    if variant == "sm90" and select_bwd_variant(q.dtype, hd, dvw) != "sm90":
        raise ValueError(f"the sm90 backward takes bfloat16 at (head dim, "
                         f"v width) {SM90_SHAPES}, not {q.dtype} at "
                         f"{(hd, dvw)}")
    if variant == "mma" and (q.dtype != torch.bfloat16 or dvw != hd
                             or hd not in MMA_BWD_HEAD_DIMS):
        raise ValueError(f"the mma backward takes bfloat16 at head dims "
                         f"{MMA_BWD_HEAD_DIMS} (v as wide), not {q.dtype} "
                         f"at {(hd, dvw)}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd kernels run on cuda, not "
                         f"{q.device}")
    Sk, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS or dvw > hd:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS} "
                         f"or v width {dvw} above it")
    ins = (q, k, v, out, dout)
    if any(t.device != q.device for t in ins):
        raise ValueError("flash_attention_bwd: tensors on different "
                         "devices")
    if any(t.stride(-1) != 1 for t in ins):
        raise ValueError("flash_attention_bwd needs a contiguous head dim")
    if variant == "fma" and dvw < hd:
        dq, dk, dv = _launch_bwd("fma", *(_pad_to(t, hd) for t in
                                          (dout, q, k, v, out)),
                                 lse, causal, window, q_offset, softcap)
        return dq, dk, dv[..., :dvw].contiguous()
    if variant == "sm90":
        check_tma_layout(q=q, k=k, v=v, out=out, dout=dout)
    elif variant == "mma":
        _check_16_bytes("flash_attention_bwd (mma)",
                        "as its 16-byte loads need",
                        dict(q=q, k=k, v=v, out=out, dout=dout))
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KV, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, KV, dvw), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = load()
    ts = (q, k, v, out, dout, dq, dk, dv)
    strides = [s for t in ts for s in t.stride()[:3]]
    scalars = (1.0 / math.sqrt(hd), int(causal), int(window), int(q_offset),
               float(softcap))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant == "sm90":
            # the rows' statistics padded to whole tiles, and each query
            # head's dK, dV in float32 before the sum over its group
            pad = -(-Sq // SM90_BWD_PAD) * SM90_BWD_PAD
            lse2 = torch.empty((B, H, pad), dtype=torch.float32,
                               device=q.device)
            delta = torch.empty_like(lse2)
            dkp = torch.empty((B, H, Sk, hd), dtype=torch.float32,
                              device=q.device)
            dvp = torch.empty((B, H, Sk, dvw), dtype=torch.float32,
                              device=q.device)
            lse = lse.contiguous()
            ptrs = (*(t.data_ptr() for t in ts[:5]), lse.data_ptr(),
                    *(t.data_ptr() for t in ts[5:]), lse2.data_ptr(),
                    delta.data_ptr(), dkp.data_ptr(), dvp.data_ptr())
            err = lib.repro_flash_attention_bwd_sm90(
                *ptrs, B, H, KV, Sq, Sk, hd, dvw, pad, *strides, *scalars,
                stream)
        else:
            # these designs compute their own row statistics: their first
            # kernel writes them and the others read them
            own_lse = torch.empty((B, H, Sq), dtype=torch.float32,
                                  device=q.device)
            delta = torch.empty_like(own_lse)
            ptrs = (*(t.data_ptr() for t in ts), own_lse.data_ptr(),
                    delta.data_ptr())
            args = (B, H, KV, Sq, Sk, hd, *strides, *scalars)
            if variant == "mma":
                err = lib.repro_flash_attention_bwd_mma(*ptrs, *args, stream)
            else:
                err = lib.repro_flash_attention_bwd(
                    *ptrs, _DTYPE_CODE[q.dtype], *args, stream)
    if err < 0:
        raise RuntimeError(f"flash_attention_bwd ({variant}): a TMA tensor "
                           f"map could not be encoded (CUresult {-err})")
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd ({variant}) launch failed: "
                           f"{msg} (cudaError {err})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.variant_launches[variant] += 1
    return dq, dk, dv


# -- the custom ops (window 0 means no window) -------------------------------
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int, q_offset: int,
            softcap: float) -> tuple[torch.Tensor, torch.Tensor]:
    return run_variant(select_variant(q.dtype, q.shape[-1], v.shape[-1]),
                       q, k, v,
                       causal=causal, window=window or None,
                       q_offset=q_offset, softcap=softcap)


@_fwd_op.register_kernel("cpu")
def _fwd_cpu(q, k, v, causal, window, q_offset, softcap):
    # contiguous, as the kernels' outputs (and the fake's) are
    out, lse = flash_attention_ref(q, k, v, causal=causal,
                                   window=window or None, q_offset=q_offset,
                                   softcap=softcap, return_lse=True)
    return out.contiguous(), lse.contiguous()


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, window, q_offset, softcap):
    B, Sq, H, _ = q.shape
    return (q.new_empty((B, Sq, H, v.shape[-1])),
            q.new_empty((B, H, Sq), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
            causal: bool, window: int, q_offset: int, softcap: float
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _launch_bwd(select_bwd_variant(q.dtype, q.shape[-1], v.shape[-1]),
                       dout, q, k, v, out, lse, causal, window, q_offset,
                       softcap)


@_bwd_op.register_kernel("cpu")
def _bwd_cpu(dout, q, k, v, out, lse, causal, window, q_offset, softcap):
    # the plain backward recomputes the softmax and does not read lse
    return tuple(t.contiguous() for t in flash_attention_bwd_ref(
        dout, q, k, v, causal=causal, window=window or None,
        q_offset=q_offset, softcap=softcap))


@_bwd_op.register_fake
def _bwd_fake(dout, q, k, v, out, lse, causal, window, q_offset, softcap):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, *attrs = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.attrs = attrs


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    # the kernels read dout through strides but need them aligned; the
    # cotangent autograd hands over is contiguous in the model's layout
    dq, dk, dv = _bwd_op(dout.contiguous(), q, k, v, out, lse, *ctx.attrs)
    return dq, dk, dv, None, None, None, None


_fwd_op.register_autograd(_backward, setup_context=_setup_context)

flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)
flash_attention_bwd.launches = 0
flash_attention_bwd.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)

__all__ = ["BWD_VARIANTS", "HEAD_DIMS", "MMA_BWD_HEAD_DIMS",
           "SM90_SHAPES", "VARIANTS", "check_tma_layout",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_ref", "load",
           "run_bwd_variant", "run_variant", "select_bwd_variant",
           "select_variant"]
