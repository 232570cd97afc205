"""Model assembly for the dense attention kinds (port of
``repro.models.transformer``).

Layers are grouped into periods (``cfg.block_pattern``); the parameters
of the ``cfg.num_periods`` identical periods are stacked along a leading
axis, as in the reference, and :func:`forward` runs the periods in a
Python loop that indexes the stacked tensors (the reference's
``lax.scan``). The port covers the ``attn``, ``swa`` and ``rwkv`` block
kinds; any other kind raises ``NotImplementedError``.

Caches are written in place (see :func:`layers.update_cache`): the
functions that take caches return the same tree they were given.
"""
from __future__ import annotations

import math

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..tree import tree_map
from . import layers as L
from .rwkv import (apply_rwkv_channelmix, apply_rwkv_timemix,
                   rwkv_cache_init, rwkv_init)

_KINDS = ("attn", "swa", "rwkv")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise NotImplementedError(
            f"block kind '{kind}' is not ported yet (have {_KINDS})")


# ----------------------------------------------------------------- blocks
def _block_init(cfg: ModelConfig, kind: str, generator: torch.Generator):
    _check_kind(kind)
    dev = generator.device
    if kind == "rwkv":
        return {"ln1": L.norm_init(cfg, dev), "tm": rwkv_init(cfg, generator),
                "ln2": L.norm_init(cfg, dev)}
    p = {"ln1": L.norm_init(cfg, dev), "mix": L.gqa_init(cfg, generator),
         "ln2": L.norm_init(cfg, dev), "ffn": L.mlp_init(cfg, generator)}
    if cfg.post_norm:
        p["pn1"] = L.norm_init(cfg, dev)
        p["pn2"] = L.norm_init(cfg, dev)
    return p


def _block_apply(cfg: ModelConfig, kind: str, p, x, *, positions,
                 cache=None, cache_pos=None):
    """One layer. Returns (x, cache)."""
    _check_kind(kind)
    h = L.apply_norm(cfg, p["ln1"], x)
    if kind == "rwkv":
        y, _ = apply_rwkv_timemix(cfg, p["tm"], h,
                                  cache=cache and cache["tm"])
        x = x + y
        h2 = L.apply_norm(cfg, p["ln2"], x)
        y2, _ = apply_rwkv_channelmix(cfg, p["tm"], h2,
                                      cache=cache and cache["cm"])
        return x + y2, cache
    y, mix_cache = L.apply_gqa(cfg, p["mix"], h, positions=positions,
                               is_global=kind == "attn",
                               kv_cache=cache and cache.get("mix"),
                               cache_pos=cache_pos)
    if cfg.post_norm:
        y = L.apply_norm(cfg, p["pn1"], y)
    x = x + y
    h2 = L.apply_norm(cfg, p["ln2"], x)
    y2 = L.apply_mlp(cfg, p["ffn"], h2)
    if cfg.post_norm:
        y2 = L.apply_norm(cfg, p["pn2"], y2)
    x = x + y2
    return x, (None if cache is None else {"mix": mix_cache})


def _block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      dtype, device):
    _check_kind(kind)
    if kind == "rwkv":
        return rwkv_cache_init(cfg, batch, dtype, device)
    return {"mix": L.gqa_cache_init(cfg, batch, max_len, dtype, device)}


def _at(tree, i: int):
    """Period ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[i], tree)


# ------------------------------------------------------------------ model
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters with the reference's tree, shapes, dtypes and
    scales, drawn from ``generator`` (which must live on ``device``).

    The generator's stream differs from ``jax.random``; to hold the port
    against the reference, carry the reference's parameters across with
    :mod:`repro_torch.bridge` instead. Stacked period tensors are filled
    one period at a time, so the peak is the model plus one period."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters "
                         f"requested on {dev}")
    dt = L.dtype_of(cfg)
    params: dict = {"embed": (torch.randn((cfg.padded_vocab, cfg.d_model),
                                          generator=generator, device=dev)
                              * 0.02).to(dt)}
    for i, kind in enumerate(cfg.prelude):
        params[f"prelude{i}"] = _block_init(cfg, kind, generator)
    periods = None
    for i in range(cfg.num_periods):
        one = {f"b{j}": _block_init(cfg, kind, generator)
               for j, kind in enumerate(cfg.block_pattern)}
        if periods is None:
            periods = tree_map(
                lambda t: t.new_empty((cfg.num_periods,) + t.shape), one)
        tree_map(lambda dst, src: dst[i].copy_(src), periods, one)
    params["periods"] = periods
    params["final_norm"] = L.norm_init(cfg, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                         cfg.padded_vocab, dt)
    return params


def lm_head_weight(cfg: ModelConfig, params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def mask_pad_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Vocab-padding columns carry untrained weights: mask to -inf."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    valid = torch.arange(cfg.padded_vocab, device=logits.device) \
        < cfg.vocab_size
    return torch.where(valid, logits, float("-inf"))


def embed_inputs(cfg: ModelConfig, params, batch: dict) -> torch.Tensor:
    if "embeds" in batch:
        x = batch["embeds"].to(L.dtype_of(cfg))
    else:
        x = params["embed"][batch["tokens"].long()]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def forward(cfg: ModelConfig, params, x: torch.Tensor, *, positions,
            caches=None, cache_pos=None):
    """Backbone forward. Returns (hidden (B,S,D), caches)."""
    for i, kind in enumerate(cfg.prelude):
        c = caches["prelude"][i] if caches is not None else None
        x, _ = _block_apply(cfg, kind, params[f"prelude{i}"], x,
                            positions=positions, cache=c,
                            cache_pos=cache_pos)
    for n in range(cfg.num_periods):
        pp = _at(params["periods"], n)
        pc = _at(caches["periods"], n) if caches is not None else None
        for i, kind in enumerate(cfg.block_pattern):
            c = pc[f"b{i}"] if pc is not None else None
            x, _ = _block_apply(cfg, kind, pp[f"b{i}"], x,
                                positions=positions, cache=c,
                                cache_pos=cache_pos)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed caches: a list for the prelude and the stacked
    ``(num_periods, batch, max_len, KV, hd)`` leaves for the periods."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg)
    prelude = [_block_cache_init(cfg, kind, batch, max_len, dt, dev)
               for kind in cfg.prelude]
    one = {f"b{i}": _block_cache_init(cfg, kind, batch, max_len, dt, dev)
           for i, kind in enumerate(cfg.block_pattern)}
    periods = tree_map(
        lambda t: t.new_zeros((cfg.num_periods,) + t.shape), one)
    return {"prelude": prelude, "periods": periods}


# ---------------------------------------------------------------- serving
def _logits(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    logits = L.linear(hidden, lm_head_weight(cfg, params)).float()
    return mask_pad_logits(cfg, logits)


def prefill(cfg: ModelConfig, params, batch: dict, max_len: int):
    """Run the prompt, fill caches of length ``max_len``. Returns
    (last_logits (B,1,V) float32, caches)."""
    x = embed_inputs(cfg, params, batch)
    B, S = x.shape[:2]
    caches = init_cache(cfg, B, max_len, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    hidden, caches = forward(cfg, params, x, positions=positions,
                             caches=caches, cache_pos=0)
    return _logits(cfg, params, hidden[:, -1:]), caches


def prefill_batched(cfg: ModelConfig, params, tokens: torch.Tensor,
                    plens: torch.Tensor):
    """Prefill a right-padded batch of prompts in one pass.

    ``tokens``: (B, S) int, right-padded; ``plens``: (B,) true prompt
    lengths. Causality hides the padding from every valid position.
    Returns (logits (B, 1, V) float32 at each row's own last prompt
    position, and the dense caches of length S)."""
    x = embed_inputs(cfg, params, {"tokens": tokens})
    B, S = tokens.shape
    caches = init_cache(cfg, B, S, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    hidden, caches = forward(cfg, params, x, positions=positions,
                             caches=caches, cache_pos=0)
    rows = torch.arange(B, device=x.device)
    last = hidden[rows, plens.to(x.device).long() - 1][:, None]  # (B,1,D)
    return _logits(cfg, params, last), caches


def decode_step(cfg: ModelConfig, params, caches, tokens_or_embeds,
                cache_pos):
    """One autoregressive step. ``tokens_or_embeds``: (B,1) int tokens
    or (B,1,D) embeds; ``cache_pos``: an int or a (B,) tensor, the
    current length of each row. Returns (logits (B,1,V) float32,
    caches)."""
    if tokens_or_embeds.is_floating_point():
        batch = {"embeds": tokens_or_embeds}
    else:
        batch = {"tokens": tokens_or_embeds}
    x = embed_inputs(cfg, params, batch)
    S = x.shape[1]
    pos = torch.as_tensor(cache_pos, device=x.device)
    positions = pos.reshape(-1, 1).to(torch.int32) + \
        torch.arange(S, dtype=torch.int32, device=x.device)
    hidden, caches = forward(cfg, params, x, positions=positions,
                             caches=caches, cache_pos=cache_pos)
    return _logits(cfg, params, hidden), caches


__all__ = ["decode_step", "embed_inputs", "forward", "init_cache",
           "init_params", "lm_head_weight", "mask_pad_logits", "prefill",
           "prefill_batched"]
