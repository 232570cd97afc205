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

Serving over a mesh whose batch axes split the rows (a serving step's
plan, :func:`~repro_torch.models.layers.serving`), a rank holds fewer
tokens than the reference's routing group when the group spans ranks
(decode: one group of all the global batch's tokens). The capacity and
the drops are then the reference's group's: the ranks' top-k choices
(T x K ints) are all-gathered over the batch axes, each assignment's
place in its expert's buffer is counted in the reference's token order
over the group, and the rank dispatches its own tokens, those within
capacity, into buffers of its own (an expert's output for a token does
not depend on its slot). ``aux`` is then the rank's own tokens' (the
serving steps discard it).
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from .layers import (activation, dense_init, dtype_of, init_shapes, linear,
                     model_mesh, serving, shard, whole)


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


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor,
          keep_fn=None):
    """The routing of groups ``xg`` (G, N, D): returns ``probs`` (G, N,
    E) float32, ``top_p`` (G, N, K) renormalised, ``top_e`` (G, N, K)
    int64, the expert one-hots (G, N, K, E) and the slot one-hots (G, N,
    K, E, C) float32, zero where an assignment is dropped. ``keep_fn``,
    where given, maps ``top_e`` and the one-hots to ``(keep, C)``, which
    assignments the group keeps and the buffers' slots (a group that
    spans ranks, :func:`_group_keep`); by default the group is ``xg``'s
    own."""
    m = cfg.moe
    G, N, _ = xg.shape
    E, K = m.num_experts, m.experts_per_token
    logits = linear(xg, router.to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    experts = torch.arange(E, device=xg.device)
    onehot = (top_e[..., None] == experts).float()            # (G,N,K,E)
    if keep_fn is None:
        C = capacity(cfg, N)
        pos_in_e = _slots(onehot)
        keep = (pos_in_e < C) & (onehot > 0)
    else:
        keep, C = keep_fn(top_e, onehot)
        pos_in_e = _slots(keep.float())
    pos = torch.where(keep, pos_in_e, 0.0).long()
    slots = torch.arange(C, device=xg.device)
    poh = ((pos[..., None] == slots) & keep[..., None]).float()
    return probs, top_p, top_e, onehot, poh


def _slots(onehot: torch.Tensor) -> torch.Tensor:
    """Each (token, k) assignment's place in its expert's buffer (G, N,
    K, E), counted over the flattened (N·K) axis: token first, then k."""
    G, N, K, E = onehot.shape
    return onehot.reshape(G, N * K, E).cumsum(1).reshape(G, N, K, E) - 1.0


def _group_keep(cfg: ModelConfig, mesh, axes: tuple, group: int):
    """``keep_fn`` of :func:`route` for a rank's tokens, one group (1, T,
    D), whose reference routing group of ``group`` tokens spans the
    ranks of ``axes``: the ranks' choices gathered (int32, in the order
    of the ranks' rows), each assignment's place counted over its
    reference group, the rank's own kept where within the reference's
    capacity. The rank's buffers hold every slot its tokens can take: at
    most one a token, and C a group its tokens touch."""
    def keep_fn(top_e, onehot):
        _, T, K, E = onehot.shape
        index = mesh._index(axes)
        every = mesh.all_gather(top_e.to(torch.int32), axes, 1)   # (1,Tg,K)
        Tg = every.shape[1]
        glob = (every.long()[..., None] == torch.arange(
            E, device=onehot.device)).float().reshape(Tg // group, group, K,
                                                      E)
        pos = _slots(glob).reshape(1, Tg, K, E)
        mine = pos.narrow(1, index * T, T)
        C = capacity(cfg, group)
        first, last = index * T // group, ((index + 1) * T - 1) // group
        return (mine < C) & (onehot > 0), min(T, (last - first + 1) * C)
    return keep_fn


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor,
              group_size: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (out (B, S, D) in x's dtype, the float32
    load-balancing loss E · mean_g Σ_e frac_tokens · frac_probs).

    B·S must be a multiple of the group, ``min(group_size, B·S)``."""
    m = cfg.moe
    B, S, D = x.shape
    E = m.num_experts
    T = B * S
    keep_fn = None
    rows = serving()
    n_dp, Tg = 1, T
    if rows is not None and rows[1]["rows"]:
        from ..sharding.rules import batch_axes
        axes = batch_axes(rows[0])
        n_dp = math.prod(rows[0].shape[a] for a in axes)
        Tg = T * n_dp       # the reference's tokens: every rank's rows
    N = min(group_size, Tg)
    if Tg % N:
        raise ValueError(
            f"MoE groups: {Tg} tokens is not a multiple of the group of "
            f"{N} tokens; pad the batch to a multiple of {group_size}")
    if T % N:               # the reference's group spans ranks
        keep_fn = _group_keep(cfg, rows[0], axes, N)
        N = T
    G = T // N
    xg = shard(x.reshape(G, N, D), "gnd")
    probs, top_p, _, onehot, poh = route(cfg, p["router"], xg, keep_fn)
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
