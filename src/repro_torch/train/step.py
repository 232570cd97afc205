"""The step builders (port of ``repro.train.step``'s
``build_train_step``, ``build_encoder_train_step``, ``build_prefill_step``
and ``build_serve_step``, and ``rules_total_dp``).

The gradient is taken as ``conformance.make_train_step`` takes it:
``torch.autograd.grad`` over per-layer leaves (the periods unbound by
:func:`~repro_torch.models.unstack_periods`, views of the stacked
tensors), then :func:`.optimizer.apply_updates` writes AdamW's update
into the stacked parameters and optimizer state through the same views,
so no whole stack is copied.

``build_train_step(..., mesh=)`` is the step over a
:class:`~repro_torch.distributed.ProcessMesh`: data parallel with ZeRO-1
over the batch axes (``pod`` x ``data``), and tensor parallel over
``model`` when that axis is above 1 (every block kind). Each rank holds
its block of every parameter as ``rules.param_specs`` and
``rules.param_parts`` place it (:func:`shard_params`; whole when
``model`` is 1) and takes the loss and gradient of its slice of the
batch with its blocks, under ``layers.activation_sharding``; its
gradients are then blocks of the whole gradient already (a tensor held
whole on every rank of ``model`` gets the same gradient on each), so
they are mean-reduced over the batch axes only, in float32. AdamW's
``master``, ``mu`` and ``nu`` hold each rank's block of every tensor by
``rules.zero1_specs`` (:func:`init_zero1_state`): its block over
``model`` cut again over ``data``; each rank updates its blocks, clipped
by the whole gradient's norm (the squares summed over the axes that
split each tensor, so a tensor held whole counts once), casts them to the
parameters' dtype and all-gathers them over ``data`` (the reference
forces the cast before the gather: ``repro/train/step.py:64-67``). Each
rank needs only its block of the mean gradient, so a leaf split over
``data`` is reduce-scattered over it and then all-reduced over ``pod``:
a rank moves about half the bytes of one all-reduce over both axes.

``build_prefill_step(..., mesh=)`` and ``build_serve_step(..., mesh=)``
serve over a mesh the same way: each rank holds its blocks of the
parameters and of the caches (:func:`shard_caches`,
``rules.serve_cache_specs``) and runs its rows under the reference's
activation plan with the serving entry the layers read
(``layers.serving``).
"""
from __future__ import annotations

import contextlib
import math

import torch

from .. import resolve_device
from ..configs.base import ModelConfig, ShapeConfig
from ..models import (check_remat_policy, decode_step, encoder_logits,
                      input_specs, loss_fn, params_spec, prefill,
                      unstack_periods)
from ..models.layers import activation_sharding
from ..tree import tree_flatten, tree_map, tree_unflatten
from .optimizer import AdamWConfig, apply_updates, init_state

#: the optimizer-state trees that have the parameters' shape
_PARAM_SHAPED = ("master", "mu", "nu")


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                     remat_policy: str = "dots", device=None, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``device`` (``None``: cuda): the loss and its gradient
    (``remat_policy`` one of ``"dots"``, the reference's default,
    ``"dots_no_batch"``, ``"full"`` or ``"none"``, see
    :func:`~repro_torch.models.forward`), then one AdamW step **in place**
    (the returned trees are the ones given). ``batch`` holds numpy arrays
    or tensors (``tokens`` or ``embeds``, ``targets``), moved to the
    device. ``metrics``: 0-d tensors ``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr`` and ``skipped``.

    With ``mesh`` the step is the one of the module's docstring:
    ``params`` holds this rank's blocks (:func:`shard_params`),
    ``batch`` is this rank's slice, ``opt_state`` comes from
    :func:`init_zero1_state`, and the metrics are the global ones (the
    loss averaged over the ranks, the whole gradient's norm)."""
    opt_cfg = opt_cfg or AdamWConfig()
    check_remat_policy(remat_policy)
    dev = resolve_device(device)
    if mesh is not None:
        return _zero1_train_step(cfg, opt_cfg, remat_policy, dev, mesh)

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


def _check_mesh(mesh) -> None:
    if "data" not in mesh.shape:
        raise ValueError(f"a ZeRO-1 step needs a data axis, not the mesh "
                         f"{mesh.shape}")


def zero1_shardings(params, mesh):
    """The ZeRO-1 placement of every parameter-shaped optimizer tree
    (``rules.zero1_specs``, with ``rules.param_parts``) over ``mesh``: a
    tree like ``params`` (whole tensors, or anything with their
    ``.shape``) of :class:`~repro_torch.distributed.NamedSharding`."""
    from functools import partial

    from ..distributed import shardings
    from ..sharding import rules
    specs = rules.zero1_specs(rules.param_specs(params, mesh), params, mesh)
    return shardings(mesh, specs, params, partial(rules.param_parts, mesh))


def shard_params(params, mesh):
    """This rank's block of every parameter of ``params`` (whole, the
    same on every rank) by ``rules.param_specs``: the tree the step over
    ``mesh`` takes. A tensor held whole is the tensor itself; with a
    ``model`` axis of 1 that is every tensor."""
    from ..sharding import rules

    def one(p, sh):
        block = sh.shard(p)
        return p if block is p else block.clone()

    return tree_map(one, params, rules.param_shardings(params, mesh))


def _placements(cfg: ModelConfig, mesh) -> list:
    """Per parameter (``tree_flatten``'s order): its ZeRO-1 placement
    and the same placement of the rank's block over ``model`` (its
    ``data`` entry alone), from the config's whole shapes."""
    from ..distributed import NamedSharding
    shapes = params_spec(cfg)
    return [(sh, NamedSharding(mesh, tuple(None if e == "model" else e
                                           for e in sh.spec)))
            for sh in tree_flatten(zero1_shardings(shapes, mesh))[0]]


def _reduce_grads(mesh, params, grads: dict, placement: list):
    """(each parameter's block of the mean over the batch axes of the
    ranks' gradients, float32; the whole gradient's norm). ``grads`` (a
    tree like the unstacked parameters, which this empties as it goes)
    holds this rank's gradient of each of its blocks. A leaf split over
    ``data`` is reduce-scattered over it, then all-reduced over the rest;
    the others all-reduced whole. The all-reduces all start before the
    first is waited for (under gloo they run while the next leaves are
    staged). The norm from the blocks: each block's squares summed over
    the axes its tensor is split over."""
    from ..sharding import rules
    from ..sharding.rules import _paths
    dp = rules.batch_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    pending = []
    for path, (_, sh) in zip(_paths(params), placement):
        g = _stacked_grad(grads, path).to(torch.float32)
        dim = _split_dim(sh, "data")
        if dim is not None:
            g = mesh.reduce_scatter(g, "data", dim)
        rest = tuple(a for a in dp if dim is None or a != "data")
        pending.append((mesh.all_reduce_start(g, rest),
                        None if dim is not None else sh.shard))
        del g
    grads.clear()
    blocks, sq = [], torch.zeros(4, dtype=torch.float32, device=mesh.device)
    for (pend, part), (whole_sh, sh) in zip(pending, placement):
        block = pend.wait(part) / n_dp
        split = {a for e in whole_sh.spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)
                 if mesh.shape[a] > 1}
        sq[int("data" in split) + 2 * int("model" in split)] += torch.sum(
            torch.square(block))
        blocks.append(block)
    total = sq[0] + mesh.all_reduce(sq[1], "data")
    if mesh.shape.get("model", 1) > 1:
        total = total + mesh.all_reduce(sq[2], "model") + \
            mesh.all_reduce(sq[3], ("data", "model"))
    return blocks, torch.sqrt(total)


def init_zero1_state(opt_cfg: AdamWConfig, params, mesh) -> dict:
    """AdamW's state for ``params`` (whole, the same on every rank) under
    ZeRO-1 on ``mesh``: ``master``, ``mu`` and ``nu`` of this rank's
    blocks only."""
    _check_mesh(mesh)
    blocks = tree_map(lambda p, sh: sh.shard(p), params,
                      zero1_shardings(params, mesh))
    return init_state(opt_cfg, blocks)


def train_state_shardings(params, opt_state, mesh, shapes=None) -> dict:
    """The placement of ``{"params": params, "opt": opt_state}`` (the
    checkpointed tree) under the step over ``mesh``: the parameters by
    ``rules.param_specs``, the parameter-shaped state by
    :func:`zero1_shardings`, the count replicated. ``shapes`` is a tree
    of the parameters' whole shapes (``models.params_spec(cfg)``), needed
    when ``params`` holds blocks split over ``model``."""
    from ..distributed import NamedSharding
    from ..sharding import rules
    shapes = params if shapes is None else shapes
    z = zero1_shardings(shapes, mesh)
    return {"params": rules.param_shardings(shapes, mesh),
            "opt": {k: z if k in _PARAM_SHAPED else NamedSharding(mesh, ())
                    for k in opt_state}}


def _split_dim(sh, axis: str) -> int | None:
    """The dimension the placement ``sh`` splits over ``axis`` alone, or
    None."""
    return next((i for i, e in enumerate(sh.spec) if e == axis), None)


def _stacked_grad(grads, path: tuple) -> torch.Tensor:
    """The gradient of the parameter at ``path`` of the stacked tree,
    from ``grads``, a tree like the unstacked parameters."""
    from ..sharding.rules import _at
    if path[0] == "periods":
        return torch.stack([_at(g, path[1:]) for g in grads["periods"]])
    return _at(grads, path)


def _zero1_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                      remat_policy: str, dev, mesh):
    from ..sharding import rules
    _check_mesh(mesh)
    dp = rules.batch_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    plan = rules.activation_plan(mesh, cfg, kind="train")
    placement: list = []

    def mean(x: torch.Tensor) -> torch.Tensor:
        return mesh.all_reduce(x, dp, "sum") / n_dp

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if not placement:
            placement.extend(_placements(cfg, mesh))
        loss, parts, g_blocks, gnorm = grad_blocks(
            cfg, mesh, plan, placement, params, batch, remat_policy)
        leaves, structure = tree_flatten(params)
        with torch.no_grad():
            p_blocks = [sh.shard(p).clone() for p, (_, sh) in zip(leaves,
                                                                  placement)]
            _, _, om = apply_updates(
                opt_cfg, tree_unflatten(structure, p_blocks),
                tree_unflatten(structure, g_blocks), opt_state, gnorm=gnorm)
            if not int(om["skipped"]):
                for p, (_, sh), block in zip(leaves, placement, p_blocks):
                    p.copy_(sh.gather(block))
            metrics = {"loss": mean(loss),
                       **{k: mean(v) for k, v in parts.items()}, **om}
        return params, opt_state, metrics

    return train_step


def grad_blocks(cfg: ModelConfig, mesh, plan: dict, placement: list,
                params, batch: dict, remat_policy: str | None):
    """``(loss, parts, blocks, grad_norm)`` of one rank of the step over
    ``mesh``: its loss and gradient under ``plan`` (``rules.
    activation_plan``), then each parameter's block of the gradient's
    mean over the batch axes and the whole gradient's norm
    (``placement``: :func:`_placements`). The step's collectives, all but
    the parameters' gather after the update."""
    with activation_sharding(plan, mesh):
        loss, parts, grads = loss_and_grads(
            cfg, unstack_periods(cfg, params), batch, remat_policy)
    with torch.no_grad():
        blocks, gnorm = _reduce_grads(mesh, params, grads, placement)
    return loss, parts, blocks, gnorm


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


def build_prefill_step(cfg: ModelConfig, max_len: int, device=None,
                       mesh=None):
    """``prefill_step(params, batch)`` on ``device`` (``None``: cuda),
    without autograd: ``(encoder_logits (B, S, V) float32, None)`` for an
    encoder-only config, else :func:`~repro_torch.models.prefill`'s
    ``(last_logits (B, 1, V) float32, caches of length max_len)``.
    ``batch`` holds numpy arrays or tensors (``tokens`` or ``embeds``),
    moved to the device.

    With ``mesh`` (a :class:`~repro_torch.distributed.ProcessMesh` or a
    :class:`~repro_torch.distributed.TracingMesh`) the step is this
    rank's program of the reference's prefill over that mesh: ``params``
    are its blocks (:func:`shard_params`), ``batch`` its rows
    (``rules.batch_specs``: the batch over the batch axes), and it
    returns its rows' last logits (the whole vocabulary) and its blocks
    of the caches, in the layout :func:`build_serve_step` takes for
    batched decode (:func:`cache_shardings`)."""
    dev = resolve_device(device)
    if mesh is not None:
        return _mesh_prefill_step(cfg, max_len, dev, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if cfg.encoder_only:
            return encoder_logits(cfg, params, batch), None
        return prefill(cfg, params, batch, max_len)

    return prefill_step


def _serve_plan(cfg: ModelConfig, mesh, kind: str, max_len: int,
                long_context: bool) -> dict:
    """The reference's activation plan of ``kind`` over ``mesh`` and the
    serving entry the layers read (``layers.SERVE``): the axis that cuts
    the caches' sequence, their whole length, and whether the batch axes
    split the rows."""
    from ..models.layers import SERVE
    from ..sharding import rules
    return dict(rules.activation_plan(mesh, cfg, kind=kind), **{SERVE: {
        "axis": "data" if long_context else "model", "len": max_len,
        "rows": not long_context}})


def _rows(global_batch: int, mesh) -> int:
    """This rank's rows of a batch split over the batch axes."""
    n_dp = rules_total_dp(mesh)
    if global_batch % n_dp:
        raise ValueError(f"a batch of {global_batch} rows does not split "
                         f"over {n_dp} data-parallel ranks")
    return global_batch // n_dp


def _local_caches(cfg: ModelConfig, mesh, batch: int, max_len: int,
                  long_context: bool, dev) -> dict:
    """Zeroed caches: this rank's blocks of the caches of ``batch`` rows
    (the global batch) of ``max_len`` positions."""
    from ..models import cache_spec
    whole = cache_spec(cfg, batch, max_len)
    return tree_map(lambda t, sh: torch.zeros(
        sh.shard_shape(t.shape), dtype=t.dtype, device=dev), whole,
        cache_shardings(whole, mesh, long_context))


def _mesh_prefill_step(cfg: ModelConfig, max_len: int, dev, mesh):
    plan = _serve_plan(cfg, mesh, "prefill", max_len, False)

    @torch.no_grad()
    def prefill_step(params, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with activation_sharding(plan, mesh):
            if cfg.encoder_only:
                return encoder_logits(cfg, params, batch), None
            rows = next(iter(batch.values())).shape[0]
            caches = _local_caches(cfg, mesh, rows * rules_total_dp(mesh),
                                   max_len, False, dev)
            return prefill(cfg, params, batch, max_len, caches)

    return prefill_step


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig, device=None,
                     mesh=None):
    """``serve_step(params, caches, tokens, cache_pos) -> (next_tok,
    logits, new_caches)`` on ``device`` (``None``: cuda), without
    autograd: one-token decode (``shape``, a decode shape, sizes the
    caches the caller gives, ``cache_spec(cfg, shape.global_batch,
    shape.seq_len)``). ``next_tok`` is the greedy (B, 1) int32 token;
    the caches are written in place and returned. ``cache_pos`` is an
    int or a tensor; a 0-d tensor is taken for every row, as a (B,)
    tensor, so that a trace on fake tensors never reads its value.

    With ``mesh`` the step is this rank's program of the reference's
    serve step over that mesh: ``params`` its blocks
    (:func:`shard_params`), ``caches`` its blocks of each cache leaf
    (:func:`shard_caches`), ``tokens`` its rows (``rules.batch_specs``)
    and a (B,) ``cache_pos`` its rows' positions; it returns its rows'
    tokens and whole-vocabulary logits. As in the reference, the batch
    is smaller than the data-parallel ways at long context
    (``long_context``): then every rank takes the whole batch and the
    caches' sequence is cut over ``data`` (context parallelism, the plan
    ``decode_long``); else the rows are split over the batch axes and the
    sequence over ``model`` (flash-decoding)."""
    if shape.kind != "decode":
        raise ValueError(f"build_serve_step needs a decode shape, got "
                         f"{shape.name} ({shape.kind})")
    dev = resolve_device(device)
    plan = None
    if mesh is not None:
        long_context = shape.global_batch < rules_total_dp(mesh)
        if not long_context:
            _rows(shape.global_batch, mesh)
        plan = _serve_plan(cfg, mesh, "decode_long" if long_context
                           else "decode", shape.seq_len, long_context)

    @torch.no_grad()
    def serve_step(params, caches, tokens, cache_pos):
        tokens = torch.as_tensor(tokens, device=dev)
        if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 0:
            cache_pos = cache_pos.to(dev).expand(tokens.shape[0])
        with activation_sharding(plan, mesh) if plan is not None \
                else contextlib.nullcontext():
            logits, new_caches = decode_step(cfg, params, caches, tokens,
                                             cache_pos)
        next_tok = logits[:, -1:].argmax(-1).to(torch.int32)
        return next_tok, logits, new_caches

    return serve_step


def cache_shardings(caches, mesh, long_context: bool):
    """The placement of a cache tree (whole caches, or anything with
    their ``.shape``) when the steps serve over ``mesh``:
    ``rules.serve_cache_specs``, a tree of
    :class:`~repro_torch.distributed.NamedSharding`. ``long_context`` as
    for :func:`build_serve_step` (``shape.global_batch <
    rules_total_dp(mesh)``)."""
    from ..distributed import shardings
    from ..sharding import rules
    return shardings(mesh, rules.serve_cache_specs(
        mesh, caches, long_context=long_context), caches)


def shard_caches(caches, mesh, long_context: bool):
    """This rank's block of every leaf of ``caches`` (whole, the same on
    every rank) by :func:`cache_shardings`: the tree the serve step over
    ``mesh`` takes. Always a copy, since the step writes it in place."""
    return tree_map(lambda c, sh: sh.shard(c).clone(), caches,
                    cache_shardings(caches, mesh, long_context))


def abstract_train_args(cfg: ModelConfig, mesh, shape: ShapeConfig,
                        opt_cfg: AdamWConfig | None = None):
    """(params, opt_state, batch) of ``cfg`` at ``shape``'s global batch
    as ``meta`` tensors (shapes and dtypes, no storage): the reference's
    ``ShapeDtypeStruct`` arguments. ``mesh`` is unused, as there."""
    p_abs = params_spec(cfg)
    return (p_abs, init_state(opt_cfg or AdamWConfig(), p_abs),
            input_specs(cfg, shape)["batch"])


def abstract_serve_args(cfg: ModelConfig, shape: ShapeConfig):
    """(caches, tokens, cache_pos) of a decode ``shape`` as ``meta``
    tensors."""
    spec = input_specs(cfg, shape)
    return spec["caches"], spec["tokens"], spec["cache_pos"]


def rules_total_dp(mesh) -> int:
    """Data-parallel ways of ``mesh``: the product of the sizes of the
    axes the global batch shards over (:func:`repro_torch.sharding.rules.
    batch_axes`), 1 when it has none."""
    import math

    from ..sharding import rules
    return math.prod(mesh.shape[a] for a in rules.batch_axes(mesh))


__all__ = ["abstract_serve_args", "abstract_train_args",
           "build_encoder_train_step", "build_prefill_step",
           "build_serve_step", "build_train_step", "cache_shardings",
           "grad_blocks", "init_zero1_state", "loss_and_grads",
           "rules_total_dp", "shard_caches", "shard_params",
           "train_state_shardings", "zero1_shardings"]
