"""Model building blocks, dense subset (port of ``repro.models.layers``).

Conventions, as in the reference:
  * params are nested dicts of tensors; weights are (in, out), applied
    as ``x @ W``;
  * activations: x is (B, S, D); attention heads (B, S, H, hd);
  * norms, RoPE and softmax run in float32 and cast back to x's dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, torch_dtype
from ..kernels.flash_attention import ops as fops
# The decode path (one query token) is the plain attention of the
# reference, which was never a Pallas kernel; the kernel's plain version
# is that same function.
from ..kernels.flash_attention.ref import flash_attention_ref as _plain_gqa


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype, scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator,
                    device=generator.device) * scale
    return w.to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., in) and w (in, out), as one 2-D product.

    This is the product ``matmul`` folds a (B, S, in) operand into when
    its strides allow; choosing it from the shapes alone keeps the op
    sequence independent of strides, so a trace with fake tensors (whose
    strides on size-1 dims can differ from a real run's) records the
    same ops as the real run."""
    y = x.reshape(-1, x.shape[-1]) @ w
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


# ------------------------------------------------------------------ norms
def norm_init(cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """qk-norm over the head dim (gemma3)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def update_cache(cache: torch.Tensor, new: torch.Tensor,
                 pos) -> torch.Tensor:
    """Write ``new`` (B, S, ...) into ``cache`` (B, L, ...) at sequence
    position ``pos``, **in place**, and return ``cache``. The reference
    returns a fresh array; writing in place is what saves the copy of
    every layer's cache per step.

    ``pos`` is an int (uniform batch) or a (B,) tensor (continuous
    batching: each row at its own position)."""
    S = new.shape[1]
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cols = pos.to(cache.device).long()[:, None] + \
            torch.arange(S, device=cache.device)[None, :]
        cache[rows, cols] = new.to(cache.dtype)
    else:
        p0 = int(pos)
        cache[:, p0:p0 + S] = new.to(cache.dtype)
    return cache


# ------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs           # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


# ------------------------------------------------------------------- MLP
def mlp_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    p = {"w_up": dense_init(generator, d, f, dt),
         "w_down": dense_init(generator, f, d, dt)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(generator, d, f, dt)
    return p


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    up = linear(x, p["w_up"])
    if cfg.gated_mlp:
        up = activation(cfg, linear(x, p["w_gate"])) * up
    else:
        up = activation(cfg, up)
    return linear(up, p["w_down"])


# ------------------------------------------------------------- attention
def gqa_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    d, dt = cfg.d_model, dtype_of(cfg)
    dev = generator.device
    p = {"wq": dense_init(generator, d, cfg.q_dim, dt),
         "wk": dense_init(generator, d, cfg.kv_dim, dt),
         "wv": dense_init(generator, d, cfg.kv_dim, dt),
         "wo": dense_init(generator, cfg.q_dim, d, dt)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=torch.float32,
                                 device=dev)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=torch.float32,
                                 device=dev)
    return p


def multi_head_attention(q, k, v, *, causal: bool, window: int | None,
                         q_offset=0, softcap: float = 0.0) -> torch.Tensor:
    """More than one query token goes to the flash-attention kernel
    (with ``q_offset`` and ``softcap``, which the reference's Pallas
    dispatch drops); one query token (decode) to the plain attention,
    whose ``q_offset`` may be a per-row (B,) tensor."""
    if q.shape[1] > 1:
        return fops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=int(q_offset), softcap=softcap)
    return _plain_gqa(q, k, v, causal=causal, window=window,
                      q_offset=q_offset, softcap=softcap)


def apply_gqa(cfg: ModelConfig, p, x: torch.Tensor, *, positions,
              is_global: bool, kv_cache=None, cache_pos=None):
    """GQA attention layer. Prefill/training: ``kv_cache`` None → full
    sequence. Decode: ``kv_cache = dict(k=(B,Smax,KV,hd), v=...)``,
    written in place at ``cache_pos``.

    Returns (out, kv_cache)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(x, p["wq"])
    k = linear(x, p["wk"])
    v = linear(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_head_norm(k, p["k_norm"], cfg.norm_eps)
    theta = (cfg.rope_theta_global if (is_global and cfg.rope_theta_global)
             else cfg.rope_theta)
    if not cfg.encoder_only:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    window = None if is_global else cfg.sliding_window
    if kv_cache is None:
        out = multi_head_attention(q, k, v, causal=cfg.causal, window=window,
                                   q_offset=0, softcap=cfg.softcap)
    else:
        ck = update_cache(kv_cache["k"], k, cache_pos)
        cv = update_cache(kv_cache["v"], v, cache_pos)
        out = multi_head_attention(q, ck, cv, causal=True, window=window,
                                   q_offset=cache_pos, softcap=cfg.softcap)
    out = linear(out.reshape(B, S, H * hd), p["wo"])
    return out, kv_cache


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


__all__ = ["activation", "apply_gqa", "apply_mlp", "apply_norm",
           "apply_rope", "dense_init", "dtype_of", "gqa_cache_init",
           "gqa_init", "linear", "mlp_init", "multi_head_attention",
           "norm_init", "rms_head_norm", "rope_freqs", "update_cache"]
