"""Gradient compression for the slow (cross-pod) axis (port of
``repro.train.compression``).

int8 quantized all-reduce with error feedback (the EF-SGD / 1-bit-Adam
family): each pod quantizes (gradient + carried error) to int8 with a
scale shared over the axis, all-reduces the int8 payload (in int32, so
that the sum cannot wrap), dequantizes, and carries the quantization
residual into the next step. The float32 master weights are untouched.

The reference writes the per-device body once and maps it over the
``pod`` axis with ``shard_map``; here each rank of a
:class:`~repro_torch.distributed.ProcessMesh` runs the body itself, and
the ``pmax`` and ``psum`` are the mesh's.
"""
from __future__ import annotations

from typing import Any

import torch

from ..tree import tree_flatten, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale) with ``scale = max |x| / 127``."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_int8_psum(mesh, grads: Any, errors: Any, axis_name: str,
                 n_shards: int) -> tuple[Any, Any]:
    """Error-feedback int8 all-reduce of this rank's ``grads`` over
    ``axis_name`` of ``mesh``, ``errors`` (a tree like ``grads``, float32)
    the residual carried in. Returns (the mean over the axis, float32,
    the same on every rank of it; the new residual, this rank's).

    The reference's per-tensor body, with its collectives batched: one
    ``pmax`` of the vector of every tensor's largest magnitude (the
    per-tensor scales), then every tensor's int32 ``psum`` started at
    once and waited in turn."""
    flat_g, structure = tree_flatten(grads)
    gfs = [g.to(torch.float32) + e
           for g, e in zip(flat_g, tree_flatten(errors)[0])]
    if not gfs:
        return grads, errors
    # one scalar pmax a tensor gives every rank the same scale, so the
    # int8 sum is exact up to the rounding (<= max/127 an element)
    m = mesh.pmax(torch.stack([gf.abs().max() for gf in gfs]), axis_name)
    scales = m / 127.0 + 1e-12
    pending, new_e = [], []
    for gf, scale in zip(gfs, scales):
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        new_e.append(gf - q.to(torch.float32) * scale)
        pending.append(mesh.all_reduce_start(q.to(torch.int32), axis_name))
    del gfs
    red = [p.wait().to(torch.float32) * scale / n_shards
           for p, scale in zip(pending, scales)]
    return tree_unflatten(structure, red), tree_unflatten(structure, new_e)


def make_compressed_psum(mesh, axis_name: str = "pod"):
    """:func:`ef_int8_psum` over ``axis_name`` of ``mesh``, in the
    reference's layout: ``fn(grads, errors) -> (reduced, new_errors)``,
    where each rank gives its block of the gradients (the reference's
    ``P(axis_name)`` on dim 0) and the replicated error state (a fresh
    :func:`init_error_state`), and gets back the mean (``P()``: the same
    on every rank) and its own new error (``P(axis_name)``)."""
    n = mesh.axis_size(axis_name)
    return lambda g, e: ef_int8_psum(mesh, g, e, axis_name, n)


def init_error_state(params_or_grads: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params_or_grads)


def compression_ratio(dtype=torch.bfloat16) -> float:
    """Bytes of ``dtype`` over bytes of int8 on the wire."""
    return torch.empty((), dtype=dtype).element_size() / \
        torch.empty((), dtype=torch.int8).element_size()


__all__ = ["compression_ratio", "dequantize_int8", "ef_int8_psum",
           "init_error_state", "make_compressed_psum", "quantize_int8"]
