"""RWKV-6 (Finch) block (port of ``repro.models.rwkv``)
[arXiv:2404.05892].

Per head (dim hd), with receptance r_t, key k_t, value v_t, decay w_t
(data-dependent, via a LoRA on the token-shifted input) and bonus u:

    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

More than one token (training, prefill, prefill-with-state) goes to the
chunked-recurrence kernel (:func:`..kernels.rwkv6.ops.wkv6`), where the
reference calls its jnp ``_wkv_chunked``; one token (decode) runs the
reference's per-token update in plain PyTorch, which was never a Pallas
kernel. Channel mixing is the standard RWKV squared-ReLU FFN.

Parameters keep the reference's tree, dtypes and scales: ``w0``, ``u``
and ``ln_x`` are float32, the rest the config's dtype, and the channel
mix's parameters live beside the time mix's (``p["tm"]`` in the block).
The cache is ``{"tm": {"x_prev", "S"}, "cm": {"x_prev"}}`` with ``S``
float32; the functions that take a cache write it **in place** (as
:func:`.layers.update_cache` does) and return the same dicts.

Under tensor parallelism (:func:`.layers.model_mesh`) the time
mix runs the rank's H/m heads: ``w_r``, ``w_k``, ``w_v``, ``w_g`` and
``w_lora_b`` by columns, ``w0``, ``ln_x`` and ``u`` by heads, ``w_o`` by
rows; *f* at its input (every path from it reaches a split product),
the token-shift coefficients and ``w_lora_a`` whole with their partial
gradients summed, *g* after ``w_o``. The channel mix is Megatron's MLP
(``cm_k`` by columns, ``cm_v`` by rows) beside the whole ``cm_r``: its
*f* sits right before ``cm_k``, since ``xm`` feeds ``cm_r`` too.
Serving over a mesh (:func:`.layers.serving`), the cache's ``S`` holds
the rank's heads (``rules.serve_cache_specs``) and an ``x_prev`` cut on
D is gathered where the token shift reads it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv6.ops import wkv6
from .layers import (dense_init, dtype_of, init_shapes, model_mesh,
                     serving, shard, whole)


def rwkv_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv.head_dim
    H = d // hd
    r = cfg.rwkv.lora_w
    dt = dtype_of(cfg)
    dev = generator.device
    f32 = torch.float32

    def full(value, dtype=dt):
        return torch.full((d,), value, dtype=dtype, device=dev)

    return {
        # token-shift mixing coefficients per projection
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_g": full(0.5), "mu_w": full(0.5),
        "w_r": dense_init(generator, d, d, dt),
        "w_k": dense_init(generator, d, d, dt),
        "w_v": dense_init(generator, d, d, dt),
        "w_g": dense_init(generator, d, d, dt),
        "w_o": dense_init(generator, d, d, dt),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full(-6.0, f32),
        "w_lora_a": dense_init(generator, d, r, dt),
        "w_lora_b": dense_init(generator, r, d, dt, scale=0.01),
        "u": torch.randn((H, hd), generator=generator, device=dev) * 0.1,
        "ln_x": full(1.0, f32),     # group-norm scale on the output
        # channel mix
        "cm_mu": full(0.5),
        "cm_k": dense_init(generator, d, cfg.d_ff, dt),
        "cm_v": dense_init(generator, cfg.d_ff, d, dt),
        "cm_r": dense_init(generator, d, d, dt),
    }


def _shifted(x: torch.Tensor, cache) -> torch.Tensor:
    """x one token later: the cached last token (or zeros) first. Under
    :func:`.layers.serving` a cached ``x_prev`` cut on D (over the axis
    that cuts the caches, as ``rules.cache_specs`` places it) is gathered
    whole first."""
    if cache is None:
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
    prev = cache["x_prev"]
    if prev.shape[-1] < x.shape[-1]:
        mesh, entry = serving()
        prev = mesh.all_gather(prev, entry["axis"], -1)
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], 1)


def _keep_last(x: torch.Tensor, cache) -> None:
    """Write x's last token into the cache's ``x_prev``, **in place**:
    this rank's block of D where the cache holds one."""
    prev = cache["x_prev"]
    last = x[:, -1]
    if prev.shape[-1] < last.shape[-1]:
        mesh, entry = serving()
        n = prev.shape[-1]
        last = last.narrow(-1, mesh.axis_index(entry["axis"]) * n, n)
    prev.copy_(last)


#: the time mix's whole tensors read before its split products
_TM_WHOLE = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w_lora_a")
_TM_SPLIT = ("w_r", "w_k", "w_v", "w_g", "w_o", "w0", "w_lora_b", "u",
             "ln_x")


def _timemix_tensor_parallel(cfg: ModelConfig, p, mesh):
    """(p, split) for this rank of :func:`.layers.model_mesh`: with
    ``w_r`` split by whole heads the rank's blocks and the whole tensors
    of :data:`_TM_WHOLE`, whose partial gradients are summed; else every
    tensor gathered (the same compute on every rank)."""
    shapes = init_shapes(rwkv_init, cfg)
    H = cfg.d_model // cfg.rwkv.head_dim
    split = p["w_r"].shape[1] < shapes["w_r"][1] and \
        H % mesh.axis_size("model") == 0
    keys = _TM_WHOLE + _TM_SPLIT
    if not split:
        return {k: whole(p[k], shapes[k], False) for k in keys}, False
    return dict({k: p[k] for k in _TM_SPLIT},
                **{k: whole(p[k], shapes[k], True) for k in _TM_WHOLE}), True


def apply_rwkv_timemix(cfg: ModelConfig, p, x: torch.Tensor, *,
                       cache=None, chunk: int = 64):
    """x: (B, S, D). cache: {"x_prev": (B, D), "S": (B, H, hd, hd)},
    written in place. Returns (out, cache). Under
    :func:`.layers.model_mesh` the rank's heads (the module's
    docstring); serving, the cache's ``S`` holds the same heads
    (``rules.serve_cache_specs``)."""
    B, S, D = x.shape
    hd = cfg.rwkv.head_dim
    mesh = model_mesh()
    split = False
    if mesh is not None:
        p, split = _timemix_tensor_parallel(cfg, p, mesh)
        if split:
            x = mesh.copy_to(x, "model")
    H = p["w_r"].shape[1] // hd
    x_prev = _shifted(x, cache)

    def mix(mu):
        return x * mu + x_prev * (1 - mu)

    r = (mix(p["mu_r"]) @ p["w_r"]).reshape(B, S, H, hd)
    k = (mix(p["mu_k"]) @ p["w_k"]).reshape(B, S, H, hd)
    v = (mix(p["mu_v"]) @ p["w_v"]).reshape(B, S, H, hd)
    g = F.silu(mix(p["mu_g"]) @ p["w_g"])
    xw = mix(p["mu_w"])
    w_log = p["w0"] + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
                       ).float()
    w = torch.exp(-torch.exp(w_log)).reshape(B, S, H, hd)  # decay in (0,1)
    r, k, v = shard(r, "bshd"), shard(k, "bshd"), shard(v, "bshd")

    if cache is None or S > 1:
        # training and prefill; with a cache, prefill-with-state seeded
        # from the cached state
        y, S_last = wkv6(r, k, v, w, p["u"],
                         None if cache is None else cache["S"], chunk)
    else:
        St = cache["S"]
        rf, kf, vf = r.float(), k.float(), v.float()
        ys = []
        for t in range(S):
            kv = torch.einsum("bhd,bhe->bhde", kf[:, t], vf[:, t])
            ys.append(torch.einsum("bhd,bhde->bhe", rf[:, t],
                                   St + p["u"][..., None] * kv))
            St = w[:, t].float()[..., None] * St + kv
        y, S_last = torch.stack(ys, 1), St
    if cache is not None:
        _keep_last(x, cache)
        cache["S"].copy_(S_last)

    # per-head group norm, in float32
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    y = (yf.reshape(B, S, H * hd) * p["ln_x"]).to(x.dtype)
    out = (y * g) @ p["w_o"]
    return (mesh.reduce_from(out, "model") if split else out), cache


def apply_rwkv_channelmix(cfg: ModelConfig, p, x: torch.Tensor, *,
                          cache=None):
    """Squared-ReLU channel mixing. cache: {"x_prev": (B, D)}, written in
    place. Returns (out, cache). Under :func:`.layers.model_mesh` the
    rank's hidden columns where ``cm_k`` is split (the module's
    docstring), else ``cm_k`` and ``cm_v`` gathered."""
    mesh = model_mesh()
    shapes = init_shapes(rwkv_init, cfg)
    split = mesh is not None and p["cm_k"].shape[1] < shapes["cm_k"][1]
    if mesh is not None and not split:
        p = {k: whole(p[k], shapes[k], False)
             for k in ("cm_mu", "cm_k", "cm_v", "cm_r")}
    x_prev = _shifted(x, cache)
    if cache is not None:
        _keep_last(x, cache)
    xm = x * p["cm_mu"] + x_prev * (1 - p["cm_mu"])
    kk = torch.square(torch.relu(
        (mesh.copy_to(xm, "model") if split else xm) @ p["cm_k"]))
    kk = shard(kk, "btf")
    rr = torch.sigmoid(xm @ p["cm_r"])
    vv = kk @ p["cm_v"]
    return rr * (mesh.reduce_from(vv, "model") if split else vv), cache


def rwkv_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    hd = cfg.rwkv.head_dim
    H = cfg.d_model // hd
    return {"tm": {"x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                         device=device),
                   "S": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                                    device=device)},
            "cm": {"x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                         device=device)}}


__all__ = ["apply_rwkv_channelmix", "apply_rwkv_timemix", "rwkv_cache_init",
           "rwkv_init"]
