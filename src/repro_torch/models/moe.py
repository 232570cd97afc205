"""Mixture-of-Experts FFN with GShard grouped dispatch (port of
``repro.models.moe``).

Tokens are cut into G groups of N; each group dispatches into per-expert
buffers of capacity C through one-hot (dispatch, combine) tensors, and
the experts run as one batched product over the expert axis. The
semantics are the reference's, rounding points included:

* the router product runs in the compute dtype and its logits are
  upcast to float32 for the softmax;
* the top-k probabilities are renormalised by ``max(sum, 1e-9)``;
* C = min(max(ceil(N·K/E · capacity_factor), 4), N·K); an assignment's
  place in its expert's buffer is a cumsum over the flattened (N·K)
  axis, so token first, then k; an assignment past C is dropped (its
  combine weight is 0);
* ``dispatch`` and ``combine`` are built in float32 and cast to the
  compute dtype before the products with the activations;
* ties among the router's probabilities go to the lower expert index, as
  ``jax.lax.top_k`` orders them (a stable descending sort; ``torch.topk``
  orders ties otherwise);
* pad tokens route and take capacity like any other token.

Every shape is static (no ``nonzero``, no boolean indexing), so the
routing traces with ``make_fx`` and replays inside a CUDA graph.

Under tensor parallelism (:func:`~repro_torch.models.layers.model_mesh`)
the experts split over ``model`` as the rule ``expert3`` stores them: by
expert when ``E % m == 0`` (each rank runs its ``E/m`` experts on their
dispatched slots), else by the hidden dim (every expert on each rank,
``F/m`` of its hidden columns). Either way the routing runs on every
rank on the same tokens, the rank's part of the combine is summed with
the shared experts' (column and row split) and reduced over ``model``
once (*g*); the tokens stay replicated, so no all-to-all is needed.
``aux`` is the one-rank value.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from .layers import (activation, dense_init, dtype_of, init_shapes, linear,
                     model_mesh, shard, whole)


def moe_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """The reference's tree: a float32 ``router`` (d, E), expert stacks
    ``w_up``, ``w_gate`` (E, d, f) and ``w_down`` (E, f, d) in the
    compute dtype, scaled by 1/sqrt(fan-in), and the shared experts'
    dense weights where the config has them."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff
    dt = dtype_of(cfg)
    E = m.num_experts

    def expert_stack(shape):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w / math.sqrt(shape[-2])).to(dt)

    p = {"router": dense_init(generator, d, E, torch.float32),
         "w_up": expert_stack((E, d, f)),
         "w_down": expert_stack((E, f, d))}
    if cfg.gated_mlp:
        p["w_gate"] = expert_stack((E, d, f))
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        p["shared_up"] = dense_init(generator, d, fs, dt)
        p["shared_down"] = dense_init(generator, fs, d, dt)
        if cfg.gated_mlp:
            p["shared_gate"] = dense_init(generator, d, fs, dt)
    return p


def _expert_ffn(cfg: ModelConfig, p, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, G·C, D) -> (E, G·C, D); one batched product per matrix."""
    up = torch.bmm(xe, p["w_up"])
    if cfg.gated_mlp:
        up = activation(cfg, torch.bmm(xe, p["w_gate"])) * up
    else:
        up = activation(cfg, up)
    return torch.bmm(up, p["w_down"])


def capacity(cfg: ModelConfig, n: int) -> int:
    """C, the slots of each expert's buffer in a group of ``n`` tokens."""
    m = cfg.moe
    K = m.experts_per_token
    return min(max(math.ceil(n * K / m.num_experts * m.capacity_factor), 4),
               n * K)


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor):
    """The routing of groups ``xg`` (G, N, D): returns ``probs`` (G, N,
    E) float32, ``top_p`` (G, N, K) renormalised, ``top_e`` (G, N, K)
    int64, the expert one-hots (G, N, K, E) and the slot one-hots (G, N,
    K, E, C) float32, zero where an assignment is dropped."""
    m = cfg.moe
    G, N, _ = xg.shape
    E, K = m.num_experts, m.experts_per_token
    logits = linear(xg, router.to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    C = capacity(cfg, N)
    experts = torch.arange(E, device=xg.device)
    onehot = (top_e[..., None] == experts).float()            # (G,N,K,E)
    pos_in_e = onehot.reshape(G, N * K, E).cumsum(1).reshape(
        G, N, K, E) - 1.0
    keep = (pos_in_e < C) & (onehot > 0)
    pos = torch.where(keep, pos_in_e, 0.0).long()
    slots = torch.arange(C, device=xg.device)
    poh = ((pos[..., None] == slots) & keep[..., None]).float()
    return probs, top_p, top_e, onehot, poh


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor,
              group_size: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (out (B, S, D) in x's dtype, the float32
    load-balancing loss E · mean_g Σ_e frac_tokens · frac_probs).

    B·S must be a multiple of the group, ``min(group_size, B·S)``."""
    m = cfg.moe
    B, S, D = x.shape
    E = m.num_experts
    T = B * S
    N = min(group_size, T)
    if T % N:
        raise ValueError(
            f"MoE groups: {B} x {S} = {T} tokens is not a multiple of the "
            f"group of {N} tokens; pad the batch to a multiple of "
            f"{group_size}")
    G = T // N
    xg = shard(x.reshape(G, N, D), "gnd")
    probs, top_p, _, onehot, poh = route(cfg, p["router"], xg)
    C = poh.shape[-1]
    mesh = model_mesh()
    experts, tp = _expert_split(cfg, p, mesh)
    xs = xg
    if tp:
        xs, top_p = mesh.copy_to(xg, "model"), mesh.copy_to(top_p, "model")
    elif mesh is not None:
        shapes = init_shapes(moe_init, cfg)
        p = {k: whole(t, shapes[k], False) for k, t in p.items()}
    El = experts.stop - experts.start
    if El < E:
        poh = poh[:, :, :, experts]
    # each (group, expert, slot) holds at most one (token, k): the sums
    # over k are exact, as the reference's einsums over k are
    dispatch = shard(poh.sum(2).to(x.dtype), "gnec")          # (G,N,E,C)
    combine = shard((top_p[..., None, None] * poh).sum(2).to(x.dtype),
                    "gnec")
    # "gnec,gnd->egcd": (G, E·C, N) @ (G, N, D)
    xe = torch.bmm(dispatch.reshape(G, N, El * C).transpose(1, 2), xs)
    xe = shard(xe.reshape(G, El, C, D).transpose(0, 1).reshape(
        El, G * C, D), "egd")
    ye = shard(_expert_ffn(cfg, p, xe), "egd").reshape(El, G, C, D)
    # "gnec,egcd->gnd": (G, N, E·C) @ (G, E·C, D)
    out = torch.bmm(combine.reshape(G, N, El * C),
                    ye.transpose(0, 1).reshape(G, El * C, D))
    if m.num_shared_experts:
        # split by columns and rows with the experts, or whole
        shared = p["shared_up"].shape[1] < m.d_ff * m.num_shared_experts
        xsh = xs if shared or not tp else xg
        up = linear(xsh, p["shared_up"])
        if cfg.gated_mlp:
            up = activation(cfg, linear(xsh, p["shared_gate"])) * up
        else:
            up = activation(cfg, up)
        y = linear(up, p["shared_down"])
        if tp and not shared:
            out = mesh.reduce_from(out, "model") + y
            tp = False
        else:
            out = out + y
    if tp:
        out = mesh.reduce_from(out, "model")
    # Switch-style load balancing loss
    frac_tokens = onehot.sum(2).mean(1)                       # (G,E)
    frac_probs = probs.mean(1)                                # (G,E)
    aux = E * (frac_tokens * frac_probs).sum(-1).mean()
    return out.reshape(B, S, D).to(x.dtype), aux.float()


def _expert_split(cfg: ModelConfig, p, mesh) -> tuple[slice, bool]:
    """(the experts this rank runs, whether its compute is split over
    ``model``): its ``E/m`` experts when the stacks are split by expert,
    every expert on ``F/m`` hidden columns when they are split by the
    hidden dim, or every expert whole (the stacks gathered) for any other
    layout the rules leave, and without a :func:`model_mesh`."""
    E = cfg.moe.num_experts
    if mesh is None:
        return slice(0, E), False
    El, F = p["w_up"].shape[0], cfg.moe.d_ff
    if El < E:
        r = mesh.axis_index("model")
        return slice(r * El, (r + 1) * El), True
    hidden = p["w_up"].shape[2] < F and p["w_down"].shape[1] < F
    return slice(0, E), hidden


def dropped_share(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor,
                  group_size: int = 1024) -> float:
    """The share of routed (token, k) assignments that capacity drops
    for the activations ``x`` (B, S, D) entering an MoE layer."""
    T = x.shape[0] * x.shape[1]
    N = min(group_size, T)
    _, _, _, onehot, poh = route(cfg, router, x.reshape(T // N, N, -1))
    return 1.0 - float(poh.sum()) / float(onehot.sum())


__all__ = ["apply_moe", "capacity", "dropped_share", "moe_init", "route"]
