"""Sharding rules: parameter path -> per-dimension mesh axes, activation
plans, and ZeRO-1 optimizer-state sharding (port of
``repro.sharding.rules``).

The reference returns ``jax.sharding.PartitionSpec`` trees (and
``NamedSharding``s for the batch, cache and activation plans). The port
returns the same information without JAX: one tuple per tensor, an
entry per dimension, each ``None``, an axis name or a tuple of axis
names, equal to ``tuple(spec)`` of the reference's spec (a one-name
tuple is the name, as ``PartitionSpec`` stores it). The functions take
any mesh whose ``.shape`` maps axis names to sizes
(:class:`repro_torch.launch.mesh.MeshShape`) and trees of anything with
a ``.shape`` (the ``meta`` tensors of :mod:`repro_torch.models.io_spec`).
A spec tree mirrors the tensor tree; since its leaves are tuples, read
it with :func:`spec_leaves`, not ``tree_flatten``.
:func:`param_shardings` places tensors by these specs over a
:class:`~repro_torch.distributed.ProcessMesh`.

Mesh axes:
  pod   — pure data parallelism across pods (the paper's §4 hybrid)
  data  — data parallelism + ZeRO-1 optimizer sharding; doubles as
          the sequence/context-parallel axis for long-KV decode
  model — tensor/expert parallelism (Megatron-style column/row, EP)

Rules are divisibility-aware: a dim is only sharded when its size
divides the axis size (InternVL2's 151655 vocab stays replicated;
Mixtral's 8 experts fall back to intra-expert TP on a 16-way axis).

Two deviations from the reference's placement, which GSPMD's resharding
hides there: Mamba's ``w_in`` (D, 2·d_inner) is the input ``xi`` and the
gate ``z`` side by side, and the port's rank holds its channels of each
(:func:`param_parts`), not the contiguous block of columns the spec
names; and serving, the recurrent states (RWKV6's ``S``, Mamba's ``h``
and ``conv``) follow the compute's split over ``model``
(:func:`serve_cache_specs`), not :func:`cache_specs`. The specs
themselves stay the reference's.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np

from ..tree import tree_map_with_path

Entry = Any     # None | str | tuple[str, ...]
Spec = tuple    # one Entry per dimension


def _entry(a: Entry) -> Entry:
    """An axis entry as ``PartitionSpec`` stores it: a one-name tuple
    is the name."""
    if isinstance(a, (tuple, list)):
        a = tuple(a)
        return a[0] if len(a) == 1 else a
    return a


def _spec(*entries: Entry) -> Spec:
    return tuple(_entry(a) for a in entries)


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _paths(tree) -> list[tuple]:
    """The paths of ``tree``'s leaves in :func:`tree_flatten`'s order."""
    if isinstance(tree, dict):
        return [(k,) + p for k in sorted(tree) for p in _paths(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(i,) + p for i, v in enumerate(tree) for p in _paths(v)]
    return [] if tree is None else [()]


def _at(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def spec_leaves(specs: Any, tree: Any) -> list[Spec]:
    """The spec of every leaf of ``tree``, in :func:`tree_flatten`'s
    order, read from the spec tree ``specs`` that mirrors it."""
    return [_at(specs, p) for p in _paths(tree)]


# (regex, spec-for-trailing-dims). "__none__" marks an unsharded dim;
# ("expert3",) marks a MoE expert stack (E, D, F) / (E, F, D).
_RULES: list[tuple[str, tuple]] = [
    # embed: shard the FEATURE dim, so the token gather and its
    # scatter-add gradient stay local
    (r"(^|/)embed$",                    ("__none__", "model")),   # (V, D)
    (r"(^|/)lm_head$",                  ("__none__", "model")),   # (D, V)
    # MoE expert stacks: EP on the expert dim
    (r"ffn/w_(up|gate)$",               ("expert3",)),
    (r"ffn/w_down$",                    ("expert3",)),
    (r"router$",                        ("__none__", "__none__")),
    (r"shared_(up|gate)$",              ("__none__", "model")),
    (r"shared_down$",                   ("model", "__none__")),
    # attention / mlp projections
    (r"(wq|wk|wv|w_up|w_gate)$",        ("__none__", "model")),
    (r"(wo|w_down|w_out)$",             ("model", "__none__")),
    (r"(bq|bk|bv)$",                    ("model",)),
    # MLA
    (r"w_dkv$",                         ("__none__", "__none__")),
    (r"w_kr$",                          ("__none__", "__none__")),
    (r"w_(uk|uv)$",                     ("__none__", "model")),
    # mamba
    (r"mix/w_in$",                      ("__none__", "model")),
    (r"conv_w$",                        ("__none__", "model")),
    (r"(conv_b|dt_bias|/D)$",           ("model",)),
    (r"mix/w_x$",                       ("model", "__none__")),
    (r"mix/w_dt$",                      ("__none__", "model")),
    (r"A_log$",                         ("model", "__none__")),
    # rwkv
    (r"w_[rkvg]$",                      ("__none__", "model")),
    (r"w_o$",                           ("model", "__none__")),
    (r"w_lora_a$",                      ("__none__", "__none__")),
    (r"w_lora_b$",                      ("__none__", "model")),
    (r"(w0|ln_x)$",                     ("model",)),
    (r"/u$",                            ("model", "__none__")),
    (r"cm_k$",                          ("__none__", "model")),
    (r"cm_v$",                          ("model", "__none__")),
    (r"cm_r$",                          ("__none__", "__none__")),
]


def _spec_for(path: str, shape: tuple[int, ...], msize: int,
              stacked: bool, dsize: int = 1) -> Spec:
    """The spec of the parameter at ``path``: the first rule whose
    pattern matches, sharding only dims that ``msize`` divides; leaves
    under ``periods/`` (``stacked``) keep their leading period axis
    unsharded."""
    lead = (None,) if stacked else ()
    body_shape = shape[1:] if stacked else shape
    for pat, rule in _RULES:
        if not re.search(pat, path):
            continue
        if rule == ("expert3",):
            if len(body_shape) != 3:
                continue    # a dense MLP under ffn/: later rules apply
            # (E, D, F): EP over "model" when E divides it, else TP on
            # the hidden dim
            E = body_shape[0]
            if E % msize == 0:
                spec = ("model", None, None)
            elif path.endswith("w_down") and body_shape[1] % msize == 0:
                spec = (None, "model", None)
            elif body_shape[-1] % msize == 0:
                spec = (None, None, "model")
            else:
                spec = (None, None, None)
        else:
            spec = tuple(None if a == "__none__" else a for a in rule)
            if len(spec) != len(body_shape):
                spec = tuple(None for _ in body_shape)
            # divisibility fallback: drop invalid shardings
            spec = tuple(
                a if (a is None or body_shape[i] % msize == 0) else None
                for i, a in enumerate(spec))
        return _spec(*(lead + spec))
    return _spec(*(lead + tuple(None for _ in body_shape)))


def param_specs(params_shape: Any, mesh) -> Any:
    """The spec tree of a parameter tree (tensors or anything with a
    ``.shape``)."""
    msize = mesh.shape.get("model", 1)
    dsize = mesh.shape.get("data", 1)

    def one(path, leaf):
        s = _path_str(path)
        return _spec_for(s, tuple(leaf.shape), msize, "periods/" in s,
                         dsize)

    return tree_map_with_path(one, params_shape)


#: parameters whose last dimension is equal parts side by side (Mamba's
#: ``w_in``: the input ``xi`` and the gate ``z``, ``d_inner`` each)
_PARTS: list[tuple[str, int]] = [(r"mix/w_in$", 2)]


def param_parts(mesh, path: tuple, spec: Spec, shape: tuple) -> tuple:
    """The parts of the parameter at ``path`` (a tree path, under
    ``params/`` or an optimizer tree's key too) whose spec over ``mesh``
    is ``spec``: ``(1, ..., k)`` when its last dimension is :data:`_PARTS`'
    k parts split over ``model`` and each part splits, else ``()``.

    A deviation from the reference, which GSPMD's resharding hides there:
    the spec splits ``w_in``'s (D, 2·d_inner) columns into contiguous
    blocks, which at ``model`` 4 would give ranks 0-1 all of ``xi`` and
    ranks 2-3 all of ``z``. The port's rank holds its channels of each
    half, ``xi``'s then ``z``'s, so that it runs the scan on its own
    channels with no exchange; :func:`param_shardings`, the ZeRO-1
    placements, sharded checkpoints and the elastic restore all place
    the tensor so (:class:`~repro_torch.distributed.NamedSharding`'s
    ``parts``). A part that ``model`` does not divide leaves the blocks
    contiguous, and the layer gathers the tensor whole."""
    msize = mesh.shape.get("model", 1)
    s = _path_str(path)
    for pat, k in _PARTS:
        if re.search(pat, s) and spec and spec[-1] == "model" and \
                shape[-1] % (k * msize) == 0:
            return (1,) * (len(shape) - 1) + (k,)
    return ()


def param_shardings(params_shape: Any, mesh) -> Any:
    """A :class:`~repro_torch.distributed.NamedSharding` over ``mesh`` (a
    :class:`~repro_torch.distributed.ProcessMesh`) for every leaf of a
    parameter tree, by :func:`param_specs` and :func:`param_parts`:
    ``.shard(t)`` is this rank's block of a leaf, ``.gather(block)`` the
    leaf back."""
    from functools import partial

    from ..distributed import shardings
    return shardings(mesh, param_specs(params_shape, mesh), params_shape,
                     partial(param_parts, mesh))


# ------------------------------------------------------------ activations
def batch_axes(mesh) -> tuple:
    """Axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def activation_plan(mesh, cfg, *, kind: str) -> dict[str, Spec]:
    """Logical activation kinds -> spec (``btd``: batch, time, d_model;
    ``btf``: batch, time, d_ff). ``kind``: train | prefill | decode |
    decode_long. Only constraints that are always divisible are
    emitted; the rest follows the parameters."""
    dp = batch_axes(mesh)
    if not dp:
        return {}
    msize = mesh.shape.get("model", 1)
    plan = {}
    if kind in ("train", "prefill"):
        # sequence parallelism on the residual stream: the layer-boundary
        # activations shard over "model"
        plan["btd"] = _spec(dp, "model", None)
        if cfg is None or cfg.d_ff % msize == 0:
            plan["btf"] = _spec(dp, None, "model")
    elif kind == "decode":
        plan["btd"] = _spec(dp, None, None)   # one token: the batch only
    if kind == "decode_long":
        # batch 1: context parallelism shards the sequence instead
        plan["btd"] = _spec(None, None, None)
    return plan


def batch_specs(mesh, batch_tree: Any, *, long_context: bool = False
                ) -> Any:
    """Specs of the input batch: the batch dim over (pod, data)."""
    dp = batch_axes(mesh)

    def one(_, leaf):
        ndim = len(leaf.shape)
        if long_context or not dp:
            return _spec(*(None,) * ndim)
        return _spec(dp, *(None,) * (ndim - 1))

    return tree_map_with_path(one, batch_tree)


def cache_specs(mesh, cache_tree: Any, *, long_context: bool) -> Any:
    """KV and state cache specs. Batched decode: the batch over (pod,
    data) and the first sequence-like axis (size >= 1024) over "model";
    long context (batch 1): the first sequence-like axis over "data"
    and the second over "model"; states without such an axis stay
    replicated."""
    dp = batch_axes(mesh)
    dsize = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1
    data = mesh.shape.get("data", 1)
    msize = mesh.shape.get("model", 1)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        # caches under "periods" are stacked: (num_periods, B, ...)
        stacked = "periods/" in _path_str(path)
        body = shape[1:] if stacked else shape
        lead = (None,) if stacked else ()
        if not body:
            return _spec(*lead)
        spec: list = [None] * len(body)
        cands = [i for i in range(1, len(body)) if body[i] >= 1024]
        if long_context:
            if cands and body[cands[0]] % data == 0:
                spec[cands[0]] = "data"
            if len(cands) > 1 and body[cands[1]] % msize == 0:
                spec[cands[1]] = "model"
        else:
            if dp and body[0] % dsize == 0:
                spec[0] = dp
            if cands and body[cands[0]] % msize == 0:
                spec[cands[0]] = "model"
        return _spec(*(lead + tuple(spec)))

    return tree_map_with_path(one, cache_tree)


def serve_cache_specs(mesh, cache_tree: Any, *, long_context: bool) -> Any:
    """The specs the port stores the caches by when it serves over
    ``mesh``: :func:`cache_specs`' for every leaf but the recurrent
    states, which follow the compute's split instead (a deviation from
    the reference, whose GSPMD moves a state between the two layouts
    where they differ):

    * RWKV6's ``S`` (B, H, hd, hd) by heads over ``model`` where
      ``model`` divides H (the time mix then runs the rank's heads);
      :func:`cache_specs` leaves it whole, and a whole state would cost
      an all-gather of every head's new state at every step;
    * Mamba's ``h`` (B, d_inner, N) and ``conv`` (B, d_conv - 1,
      d_inner) by channels over ``model`` where ``model`` divides
      d_inner (the mixer then runs the rank's channels), and never over
      ``data``: :func:`cache_specs` splits the channels only where
      d_inner >= 1024 (over ``model`` in batched decode, the same
      layout; over ``data`` at long context).

    The batch entry stays :func:`cache_specs`'. RWKV6's ``x_prev`` (B, D)
    keeps :func:`cache_specs`' layout (D over ``model`` in batched
    decode, over ``data`` at long context, where D >= 1024): the token
    shift gathers it."""
    specs = cache_specs(mesh, cache_tree, long_context=long_context)
    msize = mesh.shape.get("model", 1)

    def one(path, leaf):
        spec = list(_at(specs, path))
        name = path[-1]
        s = _path_str(path)
        lead = 1 if "periods/" in s else 0
        dim = None
        if name == "S" and s.endswith("tm/S"):
            dim = lead + 1
        elif name == "h" and s.endswith("mix/h"):
            dim = lead + 1
        elif name == "conv" and s.endswith("mix/conv"):
            dim = lead + 2
        if dim is None:
            return tuple(spec)
        for i in range(lead + 1, len(spec)):
            spec[i] = None
        spec[dim] = "model" if leaf.shape[dim] % msize == 0 else None
        return _spec(*spec)

    return tree_map_with_path(one, cache_tree)


# ---------------------------------------------------------------- ZeRO-1
def zero1_specs(pspecs: Any, params_shape: Any, mesh) -> Any:
    """Optimizer-state specs: each parameter's spec with its first
    unsharded dim that "data" divides sharded over "data" as well
    (ZeRO-1)."""
    data = mesh.shape.get("data", 1)

    def one(path, leaf):
        spec = _at(pspecs, path)
        if data <= 1:
            return spec
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        used = any(a == "data" or (isinstance(a, tuple) and "data" in a)
                   for a in parts if a is not None)
        if used:        # already data-sharded
            return _spec(*parts)
        for i, (axis, dim) in enumerate(zip(parts, leaf.shape)):
            if axis is None and dim % data == 0 and dim >= data:
                parts[i] = "data"
                break
        return _spec(*parts)

    return tree_map_with_path(one, params_shape)


__all__ = ["activation_plan", "batch_axes", "batch_specs", "cache_specs",
           "param_parts", "param_shardings", "param_specs",
           "serve_cache_specs", "spec_leaves", "zero1_specs"]
