"""Public wrappers around the CUDA selective-scan kernels (Mamba).

One library, two kernel pairs, each float32 throughout and at
``d_state`` in :data:`STATES`:

- ``reg`` (``csrc/selective_scan_reg.cu`` and
  ``csrc/selective_scan_reg_bwd.cu``): the states in registers, several
  to a thread (:func:`fwd_states`; four backward), one exponential an
  element forward and two backward, loads through a ``cp.async`` ring.
  Every main-path launch on a CUDA tensor.
- ``lane`` (``csrc/selective_scan.cu`` and ``csrc/selective_scan_bwd.cu``):
  the first design, one thread per (batch, channel, state), kept as the
  comparison; reached only by name (:func:`run_variant`,
  :func:`run_bwd_variant`).

Neither replaces a Pallas kernel: the reference runs its scan as plain
JAX (``models.ssm._ssm_scan_chunked``); the sources say why the port has
a kernel for it and what bounds it. :func:`select_variant` names the
kernel a call launches.

Both directions are custom ops (``repro_torch::selective_scan`` and
``repro_torch::selective_scan_bwd``), so that autograd differentiates the
forward through the backward kernel and ``make_fx`` records each as one
node (the plan runtime captures it in CUDA graphs). Their CUDA
implementations launch the kernels; their CPU implementations run the
plain versions :func:`~.ref.selective_scan_ref` and
:func:`~.ref.selective_scan_bwd_ref`. The library is built with ``nvcc``
at the first call on a CUDA tensor and bound through ``ctypes``; see
:mod:`repro_torch.kernels.build`. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import load_library
from .ref import selective_scan_bwd_ref, selective_scan_ref

CSRC = Path(__file__).resolve().parent / "csrc"
#: the d_state values the kernels are instantiated for
STATES = (8, 16)
#: the kernels: ``reg`` in selective_scan_reg*.cu, ``lane`` in
#: selective_scan.cu and selective_scan_bwd.cu
VARIANTS = ("reg", "lane")
#: steps of the ``lane`` backward's tiles; it keeps the state before each
TILE = 32
#: threads (batch rows x channels) from which a ``reg`` forward thread
#: holds all N states of its channel; below, four (more threads, each
#: with four chains)
FULL_STATE_THREADS = 32768

_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_REG_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
# u, dt, Bm, Cm, A, h0, dy, dh_last; du, ddt, the partials of dBm and dCm,
# of dA, dBm, dCm, dA, dh0, the state workspace; B, S, D, N; the stream
_REG_BWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; sets the C
    signatures."""
    lib = load_library("ssm", CSRC)
    if lib.repro_ssm_fwd.argtypes is None:
        lib.repro_ssm_fwd.argtypes = _FWD_ARGTYPES
        lib.repro_ssm_fwd.restype = ctypes.c_int
        lib.repro_ssm_bwd.argtypes = _BWD_ARGTYPES
        lib.repro_ssm_bwd.restype = ctypes.c_int
        lib.repro_ssm_channels_per_block.argtypes = [ctypes.c_int]
        lib.repro_ssm_channels_per_block.restype = ctypes.c_int
        lib.repro_ssm_reg_fwd.argtypes = _REG_FWD_ARGTYPES
        lib.repro_ssm_reg_fwd.restype = ctypes.c_int
        lib.repro_ssm_reg_bwd.argtypes = _REG_BWD_ARGTYPES
        lib.repro_ssm_reg_bwd.restype = ctypes.c_int
        lib.repro_ssm_reg_bwd_channels.argtypes = [ctypes.c_int]
        lib.repro_ssm_reg_bwd_channels.restype = ctypes.c_int
        lib.repro_ssm_reg_bwd_steps.argtypes = []
        lib.repro_ssm_reg_bwd_steps.restype = ctypes.c_int
        lib.repro_ssm_error_string.argtypes = [ctypes.c_int]
        lib.repro_ssm_error_string.restype = ctypes.c_char_p
    return lib


def select_variant(d_state: int) -> str:
    """The kernel pair a CUDA call at this ``d_state`` launches: ``reg``
    for every N in :data:`STATES`; another N raises."""
    if d_state not in STATES:
        raise ValueError(f"d_state {d_state} not in the kernels' {STATES}")
    return "reg"


def fwd_states(batch: int, d_inner: int, d_state: int) -> int:
    """States a thread of the ``reg`` forward holds: all ``d_state`` of
    its channel where batch x d_inner reaches
    :data:`FULL_STATE_THREADS` (jamba's prefill and decode, B=8: 65,536
    threads of 16 chains), else 4 (its training, B=1: d_inner x 4 =
    32,768 threads of four chains). The backward always holds 4."""
    return d_state if batch * d_inner >= FULL_STATE_THREADS else 4


def _check(u, dt, Bm, Cm, A, h0, chunk: int) -> None:
    if u.dim() != 3:
        raise ValueError(f"selective_scan expects u, dt (B, S, d_inner); "
                         f"got u {tuple(u.shape)}")
    B, S, di = u.shape
    if S < 1:
        raise ValueError("selective_scan needs at least one token")
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A must be (d_inner, N) = ({di}, N), got "
                         f"{tuple(A.shape)}")
    N = A.shape[1]
    shapes = (("dt", dt, (B, S, di)), ("Bm", Bm, (B, S, N)),
              ("Cm", Cm, (B, S, N)),
              ("h0", h0, (B, di, N)))
    for name, t, shape in shapes:
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("u", u), ("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A),
                    ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    devices = {t.device for t in (u, dt, Bm, Cm, A, h0) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{sorted(map(str, devices))}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"selective_scan runs on cuda or cpu, not "
                         f"{u.device}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def selective_scan(u, dt, Bm, Cm, A, h0=None, chunk: int = 256):
    """The selective scan of the reference's
    ``models.ssm._ssm_scan_chunked``, for any S: u, dt (B, S, d_inner),
    Bm, Cm (B, S, N), A (d_inner, N), ``h0`` (B, d_inner, N) or None
    (zeros), all float32. Returns (y (B, S, d_inner), h_last (B,
    d_inner, N)), float32. Differentiable: autograd runs
    :func:`selective_scan_bwd`'s op. ``chunk`` is the reference's scan
    chunk (``MambaConfig.chunk``): it changes only the order of the
    reference's sums, so neither version reads it; the tracer prices the
    op by it (:mod:`repro_torch.core.tracing`).

    A CUDA tensor launches the forward kernel :func:`select_variant`
    names on the current stream (N in :data:`STATES`) and adds one to
    ``selective_scan.launches`` and to
    ``selective_scan.variant_launches[variant]``; anything it cannot take
    raises, and a failed launch raises. A CPU tensor runs the plain
    version :func:`selective_scan_ref`, which is not counted."""
    _check(u, dt, Bm, Cm, A, h0, chunk)
    return _fwd_op(u, dt, Bm, Cm, A, h0, chunk)


def selective_scan_bwd(u, dt, Bm, Cm, A, h0, dy, dh_last, chunk: int = 256):
    """The backward of :func:`selective_scan`: the cotangents ``dy`` (B,
    S, d_inner) of y and ``dh_last`` (B, d_inner, N) of h_last, float32,
    to (du, ddt, dBm, dCm, dA, dh0), float32, in the shapes of u, dt,
    Bm, Cm, A and the state; dh0 is the gradient of a zero state when
    ``h0`` is None.

    A CUDA tensor launches the backward kernel :func:`select_variant`
    names on the current stream and adds one to
    ``selective_scan_bwd.launches`` and to
    ``selective_scan_bwd.variant_launches[variant]``; anything it cannot
    take raises, and a failed launch raises. Repeated calls give the same
    bits (no atomics: dBm, dCm and dA come back as partials summed in a
    fixed order). A CPU tensor runs the plain version
    :func:`selective_scan_bwd_ref`, not counted."""
    _check_bwd(u, dt, Bm, Cm, A, h0, dy, dh_last, chunk)
    return _bwd_op(u, dt, Bm, Cm, A, h0, dy, dh_last, chunk)


def run_variant(variant: str, u, dt, Bm, Cm, A, h0=None, chunk: int = 256):
    """Launch the named forward kernel on CUDA tensors and count it, as
    :func:`selective_scan` does with the variant :func:`select_variant`
    names; ``chip_smoke.py`` calls it to hold and time the ``lane``
    kernel beside ``reg``. Raises for an unknown name and for tensors
    that are not on a CUDA device."""
    _check(u, dt, Bm, Cm, A, h0, chunk)
    return _launch(u, dt, Bm, Cm, A, h0, variant)


def run_bwd_variant(variant: str, u, dt, Bm, Cm, A, h0, dy, dh_last,
                    chunk: int = 256):
    """Launch the named backward kernel on CUDA tensors and count it, as
    :func:`selective_scan_bwd` does with the variant
    :func:`select_variant` names. Raises for an unknown name and for
    tensors that are not on a CUDA device."""
    _check_bwd(u, dt, Bm, Cm, A, h0, dy, dh_last, chunk)
    return _launch_bwd(u, dt, Bm, Cm, A, h0, dy, dh_last, variant)


def _check_bwd(u, dt, Bm, Cm, A, h0, dy, dh_last, chunk: int) -> None:
    _check(u, dt, Bm, Cm, A, h0, chunk)
    B, S, di = u.shape
    for name, t, shape in (("dy", dy, (B, S, di)),
                           ("dh_last", dh_last, (B, di, A.shape[1]))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{name} on {t.device}, u on {u.device}")


def _kernel_inputs(label: str, variant: str, *tensors):
    """The kernels' own checks (inputs that :func:`_check` passed): a
    known variant, a CUDA device and an N they are built for. Returns
    the tensors made contiguous (the ``reg`` kernels also refuse A and
    the states off 16-byte alignment: they read them as float4)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown {label} variant {variant!r}")
    u, A = tensors[0], tensors[4]
    if u.device.type != "cuda":
        raise ValueError(f"{label} kernels run on cuda, not {u.device}")
    select_variant(A.shape[1])
    if u.shape[0] > 65535:
        raise ValueError(f"batch {u.shape[0]} > 65535 (the grid's y)")
    return [None if t is None else t.contiguous() for t in tensors]


def _raise_if(err: int, lib, label: str) -> None:
    if err != 0:
        msg = lib.repro_ssm_error_string(err).decode()
        raise RuntimeError(f"{label} launch failed: {msg} (cudaError "
                           f"{err})")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(u, dt, Bm, Cm, A, h0, variant: Optional[str] = None):
    """The forward kernel ``variant`` (by default the one
    :func:`select_variant` names) on inputs that :func:`_check` passed."""
    variant = variant or select_variant(A.shape[1])
    u, dt, Bm, Cm, A, h0 = _kernel_inputs("selective_scan", variant, u, dt,
                                          Bm, Cm, A, h0)
    B, S, di = u.shape
    N = A.shape[1]
    y = torch.empty((B, S, di), dtype=torch.float32, device=u.device)
    h_last = torch.empty((B, di, N), dtype=torch.float32, device=u.device)
    lib = load()
    ptrs = map(_ptr, (u, dt, Bm, Cm, A, h0, y, h_last))
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        if variant == "reg":
            err = lib.repro_ssm_reg_fwd(*ptrs, B, S, di, N,
                                        fwd_states(B, di, N), stream)
        else:
            err = lib.repro_ssm_fwd(*ptrs, B, S, di, N, stream)
    _raise_if(err, lib, f"selective_scan ({variant})")
    selective_scan.launches += 1
    selective_scan.variant_launches[variant] += 1
    return y, h_last


def _launch_bwd(u, dt, Bm, Cm, A, h0, dy, dh_last,
                variant: Optional[str] = None):
    """The backward kernel ``variant`` (by default the one
    :func:`select_variant` names) on inputs that :func:`_check_bwd`
    passed; it allocates the kernels' workspaces."""
    variant = variant or select_variant(A.shape[1])
    u, dt, Bm, Cm, A, h0, dy, dh_last = _kernel_inputs(
        "selective_scan_bwd", variant, u, dt, Bm, Cm, A, h0, dy, dh_last)
    B, S, di = u.shape
    N = A.shape[1]
    lib = load()
    dev, f32 = u.device, torch.float32
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dA_part = torch.empty((B, di, N), dtype=f32, device=dev)
    dh0 = torch.empty((B, di, N), dtype=f32, device=dev)
    if variant == "reg":
        nblk = -(-di // lib.repro_ssm_reg_bwd_channels(N))
        steps = lib.repro_ssm_reg_bwd_steps()
        part = torch.empty((B, S, nblk, 2 * N), dtype=f32, device=dev)
        dBm = torch.empty((B, S, N), dtype=f32, device=dev)
        dCm = torch.empty((B, S, N), dtype=f32, device=dev)
        dA = torch.empty((di, N), dtype=f32, device=dev)
        ckpt = torch.empty((B, -(-S // steps), di, N), dtype=f32,
                           device=dev)
        args = (u, dt, Bm, Cm, A, h0, dy, dh_last, du, ddt, part, dA_part,
                dBm, dCm, dA, dh0, ckpt)
        fn = lib.repro_ssm_reg_bwd
    else:
        nblk = -(-di // lib.repro_ssm_channels_per_block(N))
        dB_part = torch.empty((B, S, nblk, N), dtype=f32, device=dev)
        dC_part = torch.empty((B, S, nblk, N), dtype=f32, device=dev)
        ckpt = torch.empty((B, -(-S // TILE), di, N), dtype=f32, device=dev)
        args = (u, dt, Bm, Cm, A, h0, dy, dh_last, du, ddt, dB_part,
                dC_part, dA_part, dh0, ckpt)
        fn = lib.repro_ssm_bwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*map(_ptr, args), B, S, di, N, stream)
    _raise_if(err, lib, f"selective_scan_bwd ({variant})")
    selective_scan_bwd.launches += 1
    selective_scan_bwd.variant_launches[variant] += 1
    if variant == "reg":  # summed in a fixed order by its second kernel
        return du, ddt, dBm, dCm, dA, dh0
    # the partials summed in a fixed order: repeated calls are bit-equal
    return (du, ddt, dB_part.sum(2), dC_part.sum(2), dA_part.sum(0), dh0)


# -- the custom ops ----------------------------------------------------------
@torch.library.custom_op("repro_torch::selective_scan", mutates_args=(),
                         device_types="cuda")
def _fwd_op(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, A: torch.Tensor, h0: Optional[torch.Tensor],
            chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    return _launch(u, dt, Bm, Cm, A, h0)


@_fwd_op.register_kernel("cpu")
def _fwd_cpu(u, dt, Bm, Cm, A, h0, chunk):
    y, h_last = selective_scan_ref(u, dt, Bm, Cm, A, h0)
    return y.contiguous(), h_last.contiguous()


@_fwd_op.register_fake
def _fwd_fake(u, dt, Bm, Cm, A, h0, chunk):
    B, S, di = u.shape
    return (u.new_empty((B, S, di)), u.new_empty((B, di, A.shape[1])))


@torch.library.custom_op("repro_torch::selective_scan_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, A: torch.Tensor, h0: Optional[torch.Tensor],
            dy: torch.Tensor, dh_last: torch.Tensor, chunk: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor, torch.Tensor]:
    return _launch_bwd(u, dt, Bm, Cm, A, h0, dy, dh_last)


@_bwd_op.register_kernel("cpu")
def _bwd_cpu(u, dt, Bm, Cm, A, h0, dy, dh_last, chunk):
    return tuple(t.contiguous() for t in selective_scan_bwd_ref(
        u, dt, Bm, Cm, A, h0, dy, dh_last))


@_bwd_op.register_fake
def _bwd_fake(u, dt, Bm, Cm, A, h0, dy, dh_last, chunk):
    B, S, di = u.shape
    return (u.new_empty(u.shape), u.new_empty(u.shape),
            Bm.new_empty(Bm.shape), Cm.new_empty(Cm.shape),
            A.new_empty(A.shape), u.new_empty((B, di, A.shape[1])))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:6])
    ctx.chunk = inputs[6]


def _backward(ctx, dy, dh_last):
    u, dt, Bm, Cm, A, h0 = ctx.saved_tensors
    B, S, di = u.shape
    if dy is None:
        dy = torch.zeros_like(u)
    if dh_last is None:
        dh_last = u.new_zeros((B, di, A.shape[1]))
    du, ddt, dBm, dCm, dA, dh0 = _bwd_op(u, dt, Bm, Cm, A, h0,
                                         dy.contiguous(),
                                         dh_last.contiguous(), ctx.chunk)
    return du, ddt, dBm, dCm, dA, None if h0 is None else dh0, None


_fwd_op.register_autograd(_backward, setup_context=_setup_context)

selective_scan.launches = 0
selective_scan.variant_launches = dict.fromkeys(VARIANTS, 0)
selective_scan_bwd.launches = 0
selective_scan_bwd.variant_launches = dict.fromkeys(VARIANTS, 0)

__all__ = ["FULL_STATE_THREADS", "STATES", "TILE", "VARIANTS", "fwd_states",
           "load", "run_bwd_variant", "run_variant", "select_variant",
           "selective_scan", "selective_scan_bwd", "selective_scan_bwd_ref",
           "selective_scan_ref"]
