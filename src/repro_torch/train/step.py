"""The step builders for one device (port of ``repro.train.step``'s
``build_train_step``, ``build_encoder_train_step``, ``build_prefill_step``
and ``build_serve_step``, and ``rules_total_dp``; their sharded forms wait
for ``pipeline_apply``, ``train/compression.py`` and the process group,
ROADMAP M4.1b): no mesh, no shardings.

The gradient is taken as ``conformance.make_train_step`` takes it:
``torch.autograd.grad`` over per-layer leaves (the periods unbound by
:func:`~repro_torch.models.unstack_periods`, views of the stacked
tensors), then :func:`.optimizer.apply_updates` writes AdamW's update
into the stacked parameters and optimizer state through the same views,
so no whole stack is copied.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..configs.base import ModelConfig, ShapeConfig
from ..models import (check_remat_policy, decode_step, encoder_logits,
                      loss_fn, prefill, unstack_periods)
from ..tree import tree_flatten, tree_unflatten
from .optimizer import AdamWConfig, apply_updates

#: the optimizer-state trees that have the parameters' shape
_PARAM_SHAPED = ("master", "mu", "nu")


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                     remat_policy: str = "dots", device=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``device`` (``None``: cuda): the loss and its gradient
    (``remat_policy`` one of ``"dots"``, the reference's default,
    ``"dots_no_batch"``, ``"full"`` or ``"none"``, see
    :func:`~repro_torch.models.forward`), then one AdamW step **in place**
    (the returned trees are the ones given). ``batch`` holds numpy arrays
    or tensors (``tokens`` or ``embeds``, ``targets``), moved to the
    device. ``metrics``: 0-d tensors ``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr`` and ``skipped``."""
    opt_cfg = opt_cfg or AdamWConfig()
    check_remat_policy(remat_policy)
    dev = resolve_device(device)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        unstacked = unstack_periods(cfg, params)
        loss, parts, grads = loss_and_grads(cfg, unstacked, batch,
                                            remat_policy)
        state = {k: unstack_periods(cfg, v) if k in _PARAM_SHAPED else v
                 for k, v in opt_state.items()}
        _, _, om = apply_updates(opt_cfg, unstacked, grads, state)
        metrics = {"loss": loss, **parts, **om}
        return params, opt_state, metrics

    return train_step


def loss_and_grads(cfg: ModelConfig, unstacked, batch: dict,
                   remat_policy: str | None = None):
    """``(loss, parts, grads)``: :func:`~repro_torch.models.loss_fn` on
    ``unstacked`` (parameters with the periods unbound,
    :func:`~repro_torch.models.unstack_periods`) and its gradient, a tree
    like ``unstacked``, all detached. A leaf the loss does not read
    (hubert's token embedding, fed frame embeddings) gets zeros, as
    ``jax.grad`` gives it."""
    leaves, structure = tree_flatten(unstacked)
    req = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        loss, parts = loss_fn(cfg, tree_unflatten(structure, req), batch,
                              remat_policy=remat_policy)
        grads = torch.autograd.grad(loss, req, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree_unflatten(structure, list(grads)))


def build_encoder_train_step(cfg: ModelConfig,
                             opt_cfg: AdamWConfig | None = None,
                             remat_policy: str = "dots", device=None):
    """Encoder-only archs use the same loss (masked prediction == CE on
    provided targets), so the standard builder applies."""
    return build_train_step(cfg, opt_cfg, remat_policy, device)


def build_prefill_step(cfg: ModelConfig, max_len: int, device=None):
    """``prefill_step(params, batch)`` on ``device`` (``None``: cuda),
    without autograd: ``(encoder_logits (B, S, V) float32, None)`` for an
    encoder-only config, else :func:`~repro_torch.models.prefill`'s
    ``(last_logits (B, 1, V) float32, caches of length max_len)``.
    ``batch`` holds numpy arrays or tensors (``tokens`` or ``embeds``),
    moved to the device."""
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if cfg.encoder_only:
            return encoder_logits(cfg, params, batch), None
        return prefill(cfg, params, batch, max_len)

    return prefill_step


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig, device=None):
    """``serve_step(params, caches, tokens, cache_pos) -> (next_tok,
    logits, new_caches)`` on ``device`` (``None``: cuda), without
    autograd: one-token decode (``shape``, a decode shape, sizes the
    caches the caller gives, ``cache_spec(cfg, shape.global_batch,
    shape.seq_len)``). ``next_tok`` is the greedy (B, 1) int32 token;
    the caches are written in place and returned. ``cache_pos`` is an
    int or a tensor; a 0-d tensor is taken for every row, as a (B,)
    tensor, so that a trace on fake tensors never reads its value."""
    if shape.kind != "decode":
        raise ValueError(f"build_serve_step needs a decode shape, got "
                         f"{shape.name} ({shape.kind})")
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, caches, tokens, cache_pos):
        tokens = torch.as_tensor(tokens, device=dev)
        if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 0:
            cache_pos = cache_pos.to(dev).expand(tokens.shape[0])
        logits, new_caches = decode_step(cfg, params, caches, tokens,
                                         cache_pos)
        next_tok = logits[:, -1:].argmax(-1).to(torch.int32)
        return next_tok, logits, new_caches

    return serve_step


def rules_total_dp(mesh) -> int:
    """Data-parallel ways of ``mesh``: the product of the sizes of the
    axes the global batch shards over (:func:`repro_torch.sharding.rules.
    batch_axes`), 1 when it has none."""
    import math

    from ..sharding import rules
    return math.prod(mesh.shape[a] for a in rules.batch_axes(mesh))


__all__ = ["build_encoder_train_step", "build_prefill_step",
           "build_serve_step", "build_train_step", "loss_and_grads",
           "rules_total_dp"]
