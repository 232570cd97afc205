"""Public wrappers around the CUDA RWKV6 chunked-recurrence kernels.

Forward: two kernels, one library: ``csrc/rwkv6_mma.cu`` (bf16 r, k, v
at the head dims in :data:`MMA_HEAD_DIMS`: mma.sync TF32 tensor-core
products in 3xTF32, two blocks per SM, cp.async loads) and
``csrc/rwkv6.cu`` (float32 FMAs: float32 r, k, v, and every head dim in
:data:`HEAD_DIMS`). :func:`select_variant` picks one from (dtype, head
dim) alone. Backward: two kernels in the same library,
``csrc/rwkv6_bwd_mma.cu`` (bf16 at :data:`MMA_HEAD_DIMS`: the two state
walks split by state tile, then a chunk-parallel gradient pass, mma.sync
TF32 in 3xTF32) and ``csrc/rwkv6_bwd.cu`` (float32 FMAs, one block per
(b, h): every dtype and head dim the forward takes);
:func:`select_bwd_variant` picks one the same way.

Both directions are custom ops (``repro_torch::wkv6`` and
``repro_torch::wkv6_bwd``), so that autograd differentiates the forward
through the backward kernel and ``make_fx`` records each as one node.
Their CUDA implementations launch the kernels; their CPU implementations
run the plain versions :func:`~.ref.wkv_ref` and
:func:`~.ref.wkv_bwd_ref`. The library is built with ``nvcc`` at the
first call on a CUDA tensor and bound through ``ctypes``; see
:mod:`repro_torch.kernels.build`. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import load_library
from .ref import wkv_bwd_ref, wkv_ref

CSRC = Path(__file__).resolve().parent / "csrc"
#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64)
#: bf16 head dims the tensor-core kernel takes (every rwkv6-7b launch)
MMA_HEAD_DIMS = (64,)
#: the kernels: ``mma`` in rwkv6_mma.cu, ``fma`` in rwkv6.cu
VARIANTS = ("mma", "fma")
#: the backward kernels: ``mma`` in rwkv6_bwd_mma.cu, ``fma`` in rwkv6_bwd.cu
BWD_VARIANTS = ("mma", "fma")
#: the largest chunk the kernels' tiles hold
MAX_CHUNK = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
# r, k, v, w, u, state0, dy, ds_last; dr, dk, dv, dw, du partials,
# dstate0, the state workspace; dtype, B, S, H, hd, chunk; the strides of
# r, k, v, w, dy and of the outputs; the stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                 + [ctypes.c_longlong] * 18 + [ctypes.c_void_p])
# the same, with two workspaces (each chunk's S_in and dS) for the one
_BWD_MMA_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                     + [ctypes.c_longlong] * 18 + [ctypes.c_void_p])


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; sets the C
    signatures."""
    lib = load_library("rwkv6", CSRC)
    fn = lib.repro_wkv6_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.repro_wkv6_mma_fwd.argtypes = _ARGTYPES
        lib.repro_wkv6_mma_fwd.restype = ctypes.c_int
        lib.repro_wkv6_mma_blocks_per_sm.argtypes = []
        lib.repro_wkv6_mma_blocks_per_sm.restype = ctypes.c_int
        lib.repro_wkv6_bwd.argtypes = _BWD_ARGTYPES
        lib.repro_wkv6_bwd.restype = ctypes.c_int
        lib.repro_wkv6_bwd_mma.argtypes = _BWD_MMA_ARGTYPES
        lib.repro_wkv6_bwd_mma.restype = ctypes.c_int
        lib.repro_wkv6_bwd_mma_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.repro_wkv6_bwd_mma_blocks_per_sm.restype = ctypes.c_int
        lib.repro_wkv6_error_string.argtypes = [ctypes.c_int]
        lib.repro_wkv6_error_string.restype = ctypes.c_char_p
    return lib


def select_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches:
    ``mma`` for bf16 at :data:`MMA_HEAD_DIMS`, else ``fma``."""
    if dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS:
        return "mma"
    return "fma"


def select_bwd_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel a CUDA call of this dtype and head dim
    launches: ``mma`` for bf16 at :data:`MMA_HEAD_DIMS`, else ``fma``."""
    return select_variant(dtype, head_dim)


def check_cp_async_layout(**tensors: torch.Tensor) -> None:
    """The ``mma`` kernel reads rows with 16-byte ``cp.async``: every
    base and every stride but the head dim's must be a multiple of 16
    bytes. Raises ValueError naming the first tensor that breaks it."""
    for name, t in tensors.items():
        size = t.element_size()
        if t.data_ptr() % 16:
            raise ValueError(f"wkv6 (mma): {name} starts at "
                             f"{t.data_ptr():#x}, not 16-byte aligned, as "
                             f"cp.async needs")
        if any((s * size) % 16 for s in t.stride()[:-1]):
            raise ValueError(f"wkv6 (mma): {name} strides "
                             f"{tuple(t.stride())} (elements of {size} "
                             f"bytes) are not all multiples of 16 bytes, "
                             f"as cp.async needs")


def _check(r, k, v, w, u, state0, chunk: int) -> None:
    if r.dim() != 4:
        raise ValueError(f"wkv6 expects r, k, v, w (B,S,H,hd); got r "
                         f"{tuple(r.shape)}")
    B, S, H, hd = r.shape
    if not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"shape mismatch: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}")
    if S < 1:
        raise ValueError("wkv6 needs at least one token")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u must be (H, hd) = {(H, hd)}, got "
                         f"{tuple(u.shape)}")
    if state0 is not None and tuple(state0.shape) != (B, H, hd, hd):
        raise ValueError(f"state0 must be (B, H, hd, hd) = "
                         f"{(B, H, hd, hd)}, got {tuple(state0.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPE_CODE:
        raise TypeError(f"r, k, v must share one dtype of "
                        f"{sorted(map(str, _DTYPE_CODE))}; got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u), ("state0", state0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    devices = {t.device for t in (r, k, v, w, u, state0) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{sorted(map(str, devices))}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def wkv6(r, k, v, w, u, state0=None, chunk: int = 64):
    """The RWKV6 recurrence over chunks. r, k, v, w: (B, S, H, hd), the
    model's layout, read through strides (the head dim must be
    contiguous); u: (H, hd); ``state0``: (B, H, hd, hd) or None (zeros).
    r, k, v are float32 or bfloat16; w, u and ``state0`` float32.
    Returns (y (B, S, H, hd) float32, S_last (B, H, hd, hd) float32), the
    function of the reference's ``models.rwkv._wkv_chunked``, for any S.
    Differentiable: autograd runs :func:`wkv6_bwd`'s op.

    A CUDA tensor launches one kernel on the current stream, the one
    :func:`select_variant` names (hd in :data:`HEAD_DIMS`, chunk at most
    :data:`MAX_CHUNK`), and adds one to ``wkv6.launches`` and to
    ``wkv6.variant_launches[variant]``; anything it cannot take raises
    (the ``mma`` kernel's r, k, v and w must also meet
    :func:`check_cp_async_layout`), and a failed launch raises. A CPU
    tensor runs the plain version :func:`wkv_ref`, which is not
    counted."""
    _check(r, k, v, w, u, state0, chunk)
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    return _fwd_op(r, k, v, w, u, state0, chunk)


def wkv6_bwd(r, k, v, w, u, state0, dy, ds_last, chunk: int = 64):
    """The backward of :func:`wkv6`: the cotangents ``dy`` (B, S, H, hd)
    of y and ``ds_last`` (B, H, hd, hd) of S_last, both float32, to (dr,
    dk, dv in r's dtype, dw (B, S, H, hd), du (H, hd) and dstate0 (B, H,
    hd, hd), float32); dstate0 is the gradient of a zero state when
    ``state0`` is None.

    A CUDA tensor launches the kernel :func:`select_bwd_variant` names on
    the current stream and adds one to ``wkv6_bwd.launches`` and to
    ``wkv6_bwd.variant_launches[variant]``; anything it cannot take
    raises (the ``mma`` kernel's r, k, v, w and dy must also meet
    :func:`check_cp_async_layout`), and a failed launch raises. Repeated
    calls give the same bits (no atomics: du comes back as partials
    summed here in a fixed order). A CPU tensor runs the plain version
    :func:`wkv_bwd_ref`, not counted."""
    _check_bwd(r, k, v, w, u, state0, dy, ds_last, chunk)
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv6_bwd runs on cuda or cpu, not {r.device}")
    return _bwd_op(r, k, v, w, u, state0, dy, ds_last, chunk)


def run_bwd_variant(variant: str, r, k, v, w, u, state0, dy, ds_last,
                    chunk: int = 64):
    """Launch the named backward kernel on CUDA tensors and count it, as
    :func:`wkv6_bwd` does with the variant :func:`select_bwd_variant`
    names; ``chip_smoke.py`` calls it to hold and time the ``fma`` kernel
    at a bf16 shape the ``mma`` kernel takes. Raises for an unknown name
    and for tensors that are not on a CUDA device."""
    _check_bwd(r, k, v, w, u, state0, dy, ds_last, chunk)
    return _launch_bwd(variant, r, k, v, w, u, state0, dy, ds_last, chunk)


def _check_bwd(r, k, v, w, u, state0, dy, ds_last, chunk: int) -> None:
    _check(r, k, v, w, u, state0, chunk)
    B, S, H, hd = r.shape
    for name, t, shape in (("dy", dy, (B, S, H, hd)),
                           ("ds_last", ds_last, (B, H, hd, hd))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")


def run_variant(variant: str, r, k, v, w, u, state0=None, chunk: int = 64):
    """Launch the named kernel on CUDA tensors and count it, as
    :func:`wkv6` does with the variant :func:`select_variant` names;
    ``chip_smoke.py`` calls it to time the ``fma`` kernel at a bf16 shape
    the ``mma`` kernel takes."""
    _check(r, k, v, w, u, state0, chunk)
    return _launch(variant, r, k, v, w, u, state0, chunk)


def _launch(variant: str, r, k, v, w, u, state0, chunk: int):
    """The named kernel's own checks, then its launch (inputs that
    :func:`_check` passed)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown wkv6 variant {variant!r}")
    B, S, H, hd = r.shape
    if variant == "mma" and select_variant(r.dtype, hd) != "mma":
        raise ValueError(f"the mma kernel takes bfloat16 at head dims "
                         f"{MMA_HEAD_DIMS}, not {r.dtype} at {hd}")
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 kernels run on cuda, not {r.device}")
    _check_kernel_shape(hd, chunk, r, k, v, w)
    if variant == "mma":
        check_cp_async_layout(r=r, k=k, v=v, w=w)
    u = u.contiguous()
    state0 = None if state0 is None else state0.contiguous()
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_last = torch.empty((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
    lib = load()
    fn = lib.repro_wkv6_mma_fwd if variant == "mma" else lib.repro_wkv6_fwd
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if state0 is None else state0.data_ptr(),
                 y.data_ptr(), s_last.data_ptr(), _DTYPE_CODE[r.dtype], B, S,
                 H, hd, chunk, *r.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *w.stride()[:3], *y.stride()[:3], stream)
    if err != 0:
        msg = lib.repro_wkv6_error_string(err).decode()
        raise RuntimeError(f"wkv6 ({variant}) launch failed: {msg} "
                           f"(cudaError {err})")
    wkv6.launches += 1
    wkv6.variant_launches[variant] += 1
    return y, s_last


def _check_kernel_shape(hd: int, chunk: int, *tensors) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > the kernel's {MAX_CHUNK}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("wkv6 needs a contiguous head dim")


def _launch_bwd(variant: str, r, k, v, w, u, state0, dy, ds_last,
                chunk: int):
    """The named backward kernel's checks, then its launch (inputs that
    :func:`_check_bwd` passed)."""
    if variant not in BWD_VARIANTS:
        raise ValueError(f"unknown wkv6_bwd variant {variant!r}")
    B, S, H, hd = r.shape
    if variant == "mma" and select_bwd_variant(r.dtype, hd) != "mma":
        raise ValueError(f"the mma backward takes bfloat16 at head dims "
                         f"{MMA_HEAD_DIMS}, not {r.dtype} at {hd}")
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd kernels run on cuda, not {r.device}")
    _check_kernel_shape(hd, chunk, r, k, v, w, dy)
    if variant == "mma":
        check_cp_async_layout(r=r, k=k, v=v, w=w, dy=dy)
    u = u.contiguous()
    state0 = None if state0 is None else state0.contiguous()
    ds_last = ds_last.contiguous()
    dev, n = r.device, -(-S // chunk)
    dr, dk, dv = (torch.empty((B, S, H, hd), dtype=r.dtype, device=dev)
                  for _ in range(3))
    dw = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    dstate0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    # the fma kernel sums du per (b, h), the mma kernel per (b, h, chunk);
    # work holds each chunk's start state (and, for mma, its dS)
    du_part = torch.empty((B, H, n, hd) if variant == "mma" else (B, H, hd),
                          dtype=torch.float32, device=dev)
    work = [torch.empty((B, H, n, hd, hd), dtype=torch.float32, device=dev)
            for _ in range(2 if variant == "mma" else 1)]
    lib = load()
    fn = lib.repro_wkv6_bwd_mma if variant == "mma" else lib.repro_wkv6_bwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if state0 is None else state0.data_ptr(),
                 dy.data_ptr(), ds_last.data_ptr(), dr.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                 du_part.data_ptr(), dstate0.data_ptr(),
                 *(t.data_ptr() for t in work), _DTYPE_CODE[r.dtype], B, S,
                 H, hd, chunk, *r.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *w.stride()[:3], *dy.stride()[:3],
                 *dr.stride()[:3], stream)
    if err != 0:
        msg = lib.repro_wkv6_error_string(err).decode()
        raise RuntimeError(f"wkv6_bwd ({variant}) launch failed: {msg} "
                           f"(cudaError {err})")
    wkv6_bwd.launches += 1
    wkv6_bwd.variant_launches[variant] += 1
    # a fixed order of the partials: repeated calls are bit-equal
    du = du_part.sum((0, 2)) if variant == "mma" else du_part.sum(0)
    return dr, dk, dv, dw, du, dstate0


# -- the custom ops ----------------------------------------------------------
@torch.library.custom_op("repro_torch::wkv6", mutates_args=(),
                         device_types="cuda")
def _fwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, state0: Optional[torch.Tensor],
            chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    return _launch(select_variant(r.dtype, r.shape[-1]), r, k, v, w, u,
                   state0, chunk)


@_fwd_op.register_kernel("cpu")
def _fwd_cpu(r, k, v, w, u, state0, chunk):
    y, s_last = wkv_ref(r, k, v, w, u, state0, chunk)
    return y.contiguous(), s_last.contiguous()


@_fwd_op.register_fake
def _fwd_fake(r, k, v, w, u, state0, chunk):
    B, S, H, hd = r.shape
    return (r.new_empty((B, S, H, hd), dtype=torch.float32),
            r.new_empty((B, H, hd, hd), dtype=torch.float32))


@torch.library.custom_op("repro_torch::wkv6_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, state0: Optional[torch.Tensor],
            dy: torch.Tensor, ds_last: torch.Tensor, chunk: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor, torch.Tensor]:
    return _launch_bwd(select_bwd_variant(r.dtype, r.shape[-1]), r, k, v, w,
                       u, state0, dy, ds_last, chunk)


@_bwd_op.register_kernel("cpu")
def _bwd_cpu(r, k, v, w, u, state0, dy, ds_last, chunk):
    dr, dk, dv, dw, du, ds0 = wkv_bwd_ref(r, k, v, w, u, state0, dy,
                                          ds_last, chunk)
    return (dr.to(r.dtype).contiguous(), dk.to(r.dtype).contiguous(),
            dv.to(r.dtype).contiguous(), dw.contiguous(), du.contiguous(),
            ds0.contiguous())


@_bwd_op.register_fake
def _bwd_fake(r, k, v, w, u, state0, dy, ds_last, chunk):
    B, S, H, hd = r.shape
    f32 = torch.float32
    return (r.new_empty(r.shape), r.new_empty(r.shape), r.new_empty(r.shape),
            r.new_empty(r.shape, dtype=f32), r.new_empty((H, hd), dtype=f32),
            r.new_empty((B, H, hd, hd), dtype=f32))


def _setup_context(ctx, inputs, output):
    r, k, v, w, u, state0, chunk = inputs
    ctx.save_for_backward(r, k, v, w, u, state0)
    ctx.chunk = chunk


def _backward(ctx, dy, ds_last):
    r, k, v, w, u, state0 = ctx.saved_tensors
    if dy is None:
        dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
    if ds_last is None:
        B, _, H, hd = r.shape
        ds_last = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                              device=r.device)
    dr, dk, dv, dw, du, ds0 = _bwd_op(r, k, v, w, u, state0,
                                      dy.contiguous(), ds_last, ctx.chunk)
    return dr, dk, dv, dw, du, None if state0 is None else ds0, None


_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def mma_blocks_per_sm() -> int:
    """Blocks of the ``mma`` kernel one SM holds at once, by the CUDA
    occupancy calculator (needs the card)."""
    n = load().repro_wkv6_mma_blocks_per_sm()
    if n < 0:
        raise RuntimeError(f"wkv6 (mma): occupancy query failed "
                           f"(cudaError {-n})")
    return n


def bwd_mma_blocks_per_sm() -> dict:
    """Blocks of the ``mma`` backward's two kernels (``walk`` and
    ``grad``) one SM holds at once, by the CUDA occupancy calculator
    (needs the card)."""
    lib, out = load(), {}
    for which, name in enumerate(("walk", "grad")):
        n = lib.repro_wkv6_bwd_mma_blocks_per_sm(which)
        if n < 0:
            raise RuntimeError(f"wkv6_bwd (mma): occupancy query failed "
                               f"(cudaError {-n})")
        out[name] = n
    return out


wkv6.launches = 0
wkv6.variant_launches = dict.fromkeys(VARIANTS, 0)
wkv6_bwd.launches = 0
wkv6_bwd.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)

__all__ = ["BWD_VARIANTS", "HEAD_DIMS", "MAX_CHUNK", "MMA_HEAD_DIMS",
           "VARIANTS", "bwd_mma_blocks_per_sm", "check_cp_async_layout",
           "load", "mma_blocks_per_sm", "run_bwd_variant", "run_variant",
           "select_bwd_variant", "select_variant", "wkv6", "wkv6_bwd",
           "wkv_bwd_ref", "wkv_ref"]
