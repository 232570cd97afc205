"""Mamba-1 selective SSM block, for Jamba's mamba layers (port of
``repro.models.ssm``).

Per channel of the inner width d_inner = expand · d_model, with state
size N, the input-dependent step dt_t and the projections B_t, C_t:

    h_t = exp(dt_t · A) ⊙ h_{t-1} + dt_t · B_t · u_t,   y_t = C_t · h_t

The recurrence runs in float32 through the selective-scan op
(:func:`..kernels.ssm.ops.selective_scan`) in all three of the
reference's cases: without a cache (training), prefill with a cached
state (S > 1) and decode (one token, the reference's step written out:
the same arithmetic). Around it, the reference's rounding points: the
projections in x's dtype, the depthwise causal conv over ``d_conv`` taps
as shifted products summed in float32 and rounded to x's dtype (not
``F.conv1d``, which cuDNN runs in TF32 on the card), SiLU as XLA spells
it (each of its steps rounded to x's dtype), ``dt = softplus((dt_lr
@ w_dt) + dt_bias)`` with the float32 bias promoting the sum to float32
before the softplus, and ``y + u · D`` in float32.

The cache is ``{"conv": (B, d_conv - 1, d_inner) in the model's dtype,
"h": (B, d_inner, N) float32}``; :func:`apply_mamba` writes it **in
place** (as :func:`.layers.update_cache` does) and returns the same dict.

Under tensor parallelism (:func:`.layers.model_mesh`) a rank runs its
d_inner/m channels: its channels of ``w_in``'s two halves (the
layout of ``rules.param_parts``), of ``conv_w``, ``conv_b``, ``w_dt``,
``dt_bias``, ``A_log`` and ``D``, and its rows of ``w_x`` and
``w_out``. *f* at the input; ``w_x``'s product is a partial sum, so it
is summed (*g*), and its gradient summed too (*f*), since ``dt_lr``,
``Bm`` and ``Cm`` are then whole tensors that each rank's channels read;
*g* after ``w_out``. Where ``model`` does not divide d_inner, the weights are
gathered and every rank runs every channel. Serving, the cache's ``conv``
and ``h`` hold the rank's channels likewise
(``rules.serve_cache_specs``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssm.ops import selective_scan
from .layers import (dense_init, dtype_of, init_shapes, linear, model_mesh,
                     shard, whole)


def _dt_rank(cfg: ModelConfig) -> int:
    return max(cfg.d_model // 16, 1)


def mamba_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    mb = cfg.mamba
    d = cfg.d_model
    di = d * mb.expand
    N = mb.d_state
    R = _dt_rank(cfg)
    dt = dtype_of(cfg)
    dev = generator.device
    f32 = torch.float32
    # real S4D init: A = -[1, ..., N] per channel, kept as its log
    a_log = torch.log(torch.arange(1, N + 1, dtype=f32, device=dev))
    return {
        "w_in": dense_init(generator, d, 2 * di, dt),   # x and gate z
        "conv_w": (torch.randn((mb.d_conv, di), generator=generator,
                               device=dev) * 0.1).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "w_x": dense_init(generator, di, R + 2 * N, dt),   # dt, B, C
        "w_dt": dense_init(generator, R, di, dt),
        "dt_bias": torch.full((di,), math.log(math.e - 1), dtype=f32,
                              device=dev),
        "A_log": a_log[None].repeat(di, 1),
        "D": torch.ones((di,), dtype=f32, device=dev),
        "w_out": dense_init(generator, di, d, dt),
    }


def _causal_conv(xpad: torch.Tensor, w: torch.Tensor, S: int):
    """Σ_k xpad[:, k : k + S] · w[k], the depthwise causal conv over the
    K = ``w.shape[0]`` taps, summed in float32 and rounded to xpad's
    dtype (the reference's einsum). The taps come from ``unbind``, whose
    gradient is one ``stack`` (an indexed tap's would be a zero tensor of
    w's shape per tap)."""
    taps = w.float().unbind(0)
    acc = xpad[:, :S].float() * taps[0]
    for k in range(1, len(taps)):
        acc = acc + xpad[:, k:k + S].float() * taps[k]
    return acc.to(xpad.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x · 1 / (1 + exp(-x)), each step rounded to x's dtype: the
    reference's ``jax.nn.silu``, whose logistic XLA spells so (in bf16,
    ``F.silu`` rounds once and differs in a third of the elements)."""
    return x * (1 / (1 + torch.exp(-x)))


def apply_mamba(cfg: ModelConfig, p, x: torch.Tensor, *, cache=None):
    """x: (B, S, D). cache: {"conv": (B, d_conv - 1, d_inner), "h": (B,
    d_inner, N)}, written in place. Returns (out, cache). Under
    :func:`.layers.model_mesh` the rank's channels (the module's
    docstring)."""
    mb = cfg.mamba
    B, S, D = x.shape
    N = mb.d_state
    R = _dt_rank(cfg)
    mesh = model_mesh()
    shapes = init_shapes(mamba_init, cfg)
    split = mesh is not None and p["conv_w"].shape[1] < shapes["conv_w"][1]
    if split:
        x = mesh.copy_to(x, "model")
    elif mesh is not None:
        p = {k: whole(t, shapes[k], False) for k, t in p.items()}
    di = p["conv_w"].shape[1]              # d_inner, or the rank's share
    xi, z = linear(x, p["w_in"]).split(di, dim=-1)          # (B, S, di)
    xi = shard(xi, "bsi")

    K = mb.d_conv
    pad = (x.new_zeros((B, K - 1, di)) if cache is None
           else cache["conv"])
    xpad = torch.cat([pad, xi], 1)                         # (B, S+K-1, di)
    xc = _silu(_causal_conv(xpad, p["conv_w"], S) + p["conv_b"])

    proj = linear(xc, p["w_x"])
    if split:       # g, then f: dt_lr, Bm and Cm feed the rank's channels
        proj = mesh.copy_to(mesh.reduce_from(proj, "model"), "model")
    dt_lr, Bm, Cm = proj.split([R, N, N], dim=-1)
    dt = F.softplus(linear(dt_lr, p["w_dt"]) + p["dt_bias"])   # float32
    A = -torch.exp(p["A_log"])                             # (di, N)
    u = xc.float()
    y, h_last = selective_scan(u, dt, Bm.float(), Cm.float(), A,
                               None if cache is None else cache["h"],
                               mb.chunk)
    if cache is not None:
        cache["conv"].copy_(xpad[:, -(K - 1):])
        cache["h"].copy_(h_last)
    y = y + u * p["D"]
    out = linear(y.to(x.dtype) * _silu(z), p["w_out"])
    return (mesh.reduce_from(out, "model") if split else out), cache


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    mb = cfg.mamba
    di = cfg.d_model * mb.expand
    return {"conv": torch.zeros((batch, mb.d_conv - 1, di), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, di, mb.d_state), dtype=torch.float32,
                             device=device)}


__all__ = ["apply_mamba", "mamba_cache_init", "mamba_init"]
