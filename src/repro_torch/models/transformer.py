"""Model assembly (port of ``repro.models.transformer``).

Layers are grouped into periods (``cfg.block_pattern``); the parameters
of the ``cfg.num_periods`` identical periods are stacked along a leading
axis, as in the reference, and :func:`forward` runs the periods in a
Python loop that indexes the stacked tensors (the reference's
``lax.scan``). The port covers every block kind of the reference:
``attn``, ``swa``, ``attn_moe``, ``swa_moe``, ``mla``, ``mla_moe``,
``rwkv``, ``mamba`` and ``mamba_moe``; an unknown kind raises
``NotImplementedError``. :func:`forward` returns each
MoE block's load-balancing loss summed over the layers, as the
reference's does, and :func:`loss_fn` adds it at the config's
``router_aux_weight``; the dense, rwkv and ``mamba`` kinds have none.

Caches are written in place (see :func:`layers.update_cache`): the
functions that take caches return the same tree they were given.

Under tensor parallelism (:func:`layers.activation_sharding` with a
``model`` axis above 1; every block kind, without a cache) the embedding
table is split on D: each rank looks up its columns and they are
all-gathered; the head is vocab-parallel where ``lm_head``'s V is split
(each rank's logits, the log-sum-exp from a ``pmax`` and a psum of
exponentials, the target logit psummed from the rank that holds it) and
row-parallel where the tied table is the head (the partial logits
psummed).

Training (:func:`loss_fn`) differentiates the parameters with the
periods unbound: :func:`unstack_periods` gives ``params["periods"]`` as
a list of per-period trees (views of the stacked tensors, made once
outside the differentiation), so that every gradient leaf is one
layer's tensor, and the update stacks each leaf once again
(``conformance.make_train_step``).
Differentiated through the stacked tensors instead, every layer's read
would become a ``select_backward`` of the whole stack's shape, and
their sum (2L - 1) whole-stack tensors per leaf.
"""
from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from ..tree import tree_map
from . import layers as L
from .moe import apply_moe, moe_init
from .rwkv import (apply_rwkv_channelmix, apply_rwkv_timemix,
                   rwkv_cache_init, rwkv_init)
from .ssm import apply_mamba, mamba_cache_init, mamba_init

_KINDS = ("attn", "swa", "attn_moe", "swa_moe", "mla", "mla_moe", "rwkv",
          "mamba", "mamba_moe")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise NotImplementedError(
            f"block kind '{kind}' is not a block kind (have {_KINDS})")


# ----------------------------------------------------------------- blocks
def _block_init(cfg: ModelConfig, kind: str, generator: torch.Generator):
    _check_kind(kind)
    dev = generator.device
    if kind == "rwkv":
        return {"ln1": L.norm_init(cfg, dev), "tm": rwkv_init(cfg, generator),
                "ln2": L.norm_init(cfg, dev)}
    mix = (mamba_init if kind.startswith("mamba") else
           L.mla_init if kind.startswith("mla") else L.gqa_init)
    p = {"ln1": L.norm_init(cfg, dev), "mix": mix(cfg, generator),
         "ln2": L.norm_init(cfg, dev),
         "ffn": (moe_init if kind.endswith("moe") else L.mlp_init)(
             cfg, generator)}
    if cfg.post_norm:
        p["pn1"] = L.norm_init(cfg, dev)
        p["pn2"] = L.norm_init(cfg, dev)
    return p


def _block_apply(cfg: ModelConfig, kind: str, p, x, *, positions,
                 cache=None, cache_pos=None):
    """One layer. Returns (x, cache, aux): ``aux`` is an MoE block's
    float32 load-balancing loss, None for the other kinds."""
    _check_kind(kind)
    h = L.apply_norm(cfg, p["ln1"], x)
    if kind == "rwkv":
        y, _ = apply_rwkv_timemix(cfg, p["tm"], h,
                                  cache=cache and cache["tm"])
        x = x + y
        h2 = L.apply_norm(cfg, p["ln2"], x)
        y2, _ = apply_rwkv_channelmix(cfg, p["tm"], h2,
                                      cache=cache and cache["cm"])
        return x + y2, cache, None
    if kind.startswith("mamba"):
        y, mix_cache = apply_mamba(cfg, p["mix"], h,
                                   cache=cache and cache.get("mix"))
    elif kind.startswith("mla"):
        y, mix_cache = L.apply_mla(cfg, p["mix"], h, positions=positions,
                                   kv_cache=cache and cache.get("mix"),
                                   cache_pos=cache_pos)
    else:
        y, mix_cache = L.apply_gqa(cfg, p["mix"], h, positions=positions,
                                   is_global=not kind.startswith("swa"),
                                   kv_cache=cache and cache.get("mix"),
                                   cache_pos=cache_pos)
    if cfg.post_norm:
        y = L.apply_norm(cfg, p["pn1"], y)
    x = x + y
    h2 = L.apply_norm(cfg, p["ln2"], x)
    aux = None
    if kind.endswith("moe"):
        y2, aux = apply_moe(cfg, p["ffn"], h2)
    else:
        y2 = L.apply_mlp(cfg, p["ffn"], h2)
    if cfg.post_norm:
        y2 = L.apply_norm(cfg, p["pn2"], y2)
    x = L.shard(x + y2, "btd")
    return x, (None if cache is None else {"mix": mix_cache}), aux


def _block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      dtype, device):
    _check_kind(kind)
    if kind == "rwkv":
        return rwkv_cache_init(cfg, batch, dtype, device)
    if kind.startswith("mamba"):
        return {"mix": mamba_cache_init(cfg, batch, dtype, device)}
    if kind.startswith("mla"):
        return {"mix": L.mla_cache_init(cfg, batch, max_len, dtype, device)}
    return {"mix": L.gqa_cache_init(cfg, batch, max_len, dtype, device)}


def _at(tree, i: int):
    """Period ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[i], tree)


def unstack_periods(cfg: ModelConfig, params) -> dict:
    """``params`` with ``"periods"`` as a list of ``cfg.num_periods``
    per-period trees: views of the stacked tensors, no copies.
    :func:`forward` and :func:`loss_fn` take this form too."""
    return dict(params, periods=[_at(params["periods"], n)
                                 for n in range(cfg.num_periods)])


# ------------------------------------------------------------------ model
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters with the reference's tree, shapes, dtypes and
    scales, drawn from ``generator`` (which must live on ``device``).

    The generator's stream differs from ``jax.random``; to hold the port
    against the reference, carry the reference's parameters across with
    :mod:`repro_torch.bridge` instead. Stacked period tensors are filled
    one block at a time, so the peak is the model plus one block (jamba's
    period of 8 blocks is half the card at full width)."""
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
    periods: dict = {}
    for i in range(cfg.num_periods):
        for j, kind in enumerate(cfg.block_pattern):
            one = _block_init(cfg, kind, generator)
            if i == 0:
                periods[f"b{j}"] = tree_map(
                    lambda t: t.new_empty((cfg.num_periods,) + t.shape), one)
            tree_map(lambda dst, src: dst[i].copy_(src), periods[f"b{j}"],
                     one)
            del one
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
    """The token embeddings (or the given ``embeds``), scaled where the
    config says. Under tensor parallelism the rank's D-columns of the
    rows, all-gathered over ``model``."""
    if "embeds" in batch:
        x = batch["embeds"].to(L.dtype_of(cfg))
    else:
        table, tokens = params["embed"], batch["tokens"].long()
        mesh = L.model_mesh()
        x = table[tokens]
        if mesh is not None and table.shape[1] < cfg.d_model:
            x = mesh.gather_from(x, "model", -1)
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return L.shard(x, "btd")


#: remat policies :func:`forward` takes, the reference's: ``None`` and
#: ``"none"`` keep every activation, ``"full"`` recomputes each period,
#: ``"dots"`` and ``"dots_no_batch"`` recompute each period but what
#: ``_SAVED`` names
REMAT_POLICIES = (None, "none", "full", "dots", "dots_no_batch")

#: products without batch dims: the weight products (the reference's
#: einsums of (B, S, in) by (in, out) are dot_generals without batch dims)
_NO_BATCH_PRODUCTS = frozenset({"aten::mm", "aten::addmm"})
#: products with batch dims. Each custom op joins by what its reference
#: counterpart is under ``jax.checkpoint``, as
#: ``jax.ad_checkpoint.print_saved_residuals`` shows on the reduced
#: configs: its output is, or is summed from, the output of a product
#: with batch dims, which ``dots_saveable`` saves and
#: ``dots_with_no_batch_dims_saveable`` does not:
#:
#: - ``repro_torch::flash_attention``: ``layers._plain_gqa``, the scores
#:   and the PV product, einsums over (batch, KV head, group);
#: - ``repro_torch::wkv6``: ``rwkv._wkv_chunked``, per-chunk einsums over
#:   (batch, head);
#: - ``repro_torch::selective_scan``: ``ssm._ssm_scan_chunked``, whose y
#:   is ``einsum("bsdn,bsn->bsd")`` over (b, s).
_BATCH_PRODUCTS = frozenset({"aten::bmm", "aten::baddbmm",
                             "repro_torch::flash_attention",
                             "repro_torch::wkv6",
                             "repro_torch::selective_scan"})


class _KeepProducts(TorchDispatchMode):
    """A period's forward under a ``dots`` policy: runs every op and keeps
    the outputs of the ops named in ``saved`` in call order, detached,
    with their version counters."""

    def __init__(self, saved: frozenset, kept: list):
        super().__init__()
        self.saved, self.kept = saved, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.name() in self.saved:
            outs = out if isinstance(out, tuple) else (out,)
            # detached with ADInplaceOrView on, the copy shares the
            # version counter that the recompute checks
            with torch._C._SetExcludeDispatchKeyGuard(
                    torch._C.DispatchKey.ADInplaceOrView, False):
                self.kept.append((isinstance(out, tuple),
                                  [(t.detach(), t._version) for t in outs]))
        return out


class _ReuseProducts(TorchDispatchMode):
    """The same period's recompute: every op runs again but those named
    in ``saved``, which return what :class:`_KeepProducts` kept."""

    def __init__(self, saved: frozenset, kept: list):
        super().__init__()
        self.saved, self.kept = saved, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.name() not in self.saved:
            return func(*args, **(kwargs or {}))
        is_tuple, entries = self.kept.pop(0)
        if any(t._version != v for t, v in entries):
            raise RuntimeError(f"remat: an output of {func.name()} was "
                               f"written in place after it was kept")
        vals = tuple(t for t, _ in entries)
        return vals if is_tuple else vals[0]


def _remat_contexts(saved: frozenset):
    """``checkpoint``'s ``context_fn`` for a ``dots`` policy: the forward
    keeps the products' outputs, the recompute reuses them and runs the
    rest. torch's ``create_selective_checkpoint_contexts`` does the same
    when run, but under a tracing proxy mode (``make_fx``, which
    ``api.trace`` uses) it keeps every op's output and leaves the
    recompute to a compiler's partitioner, so a traced step would hold
    no recompute at all; the port's planner and runtime run the traced
    graph as it stands."""
    kept: list = []
    return _KeepProducts(saved, kept), _ReuseProducts(saved, kept)


#: per policy, the ops whose outputs the period's checkpoint saves (the
#: reference's ``dots_saveable`` and ``dots_with_no_batch_dims_saveable``)
_SAVED = {"dots": _NO_BATCH_PRODUCTS | _BATCH_PRODUCTS,
          "dots_no_batch": _NO_BATCH_PRODUCTS}


def check_remat_policy(remat_policy) -> None:
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {remat_policy!r}; have "
            f"{REMAT_POLICIES[1:]}")


def _add_aux(total, aux):
    """The running sum of the blocks' aux losses (None while no block
    had one: the dense graphs keep no node for it)."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _period_apply(cfg: ModelConfig, pp, x, positions, pc, cache_pos):
    """One period. Returns (x, the sum of its blocks' aux losses or
    None)."""
    aux = None
    for i, kind in enumerate(cfg.block_pattern):
        c = pc[f"b{i}"] if pc is not None else None
        x, _, a = _block_apply(cfg, kind, pp[f"b{i}"], x,
                               positions=positions, cache=c,
                               cache_pos=cache_pos)
        aux = _add_aux(aux, a)
    return x, aux


def forward(cfg: ModelConfig, params, x: torch.Tensor, *, positions,
            caches=None, cache_pos=None, remat_policy: str | None = None):
    """Backbone forward. Returns (hidden (B,S,D), caches, aux): ``aux``
    is the float32 sum of the MoE blocks' load-balancing losses in layer
    order (0 where there is none), as the reference's forward returns it.
    ``params["periods"]`` is the stacked tree or, as
    :func:`unstack_periods` gives it, a list of per-period trees.

    ``remat_policy="full"`` (without caches) runs each period under
    ``torch.utils.checkpoint``: its backward recomputes the period from
    its input, as the reference's ``jax.checkpoint`` of the scan body
    does; ``"dots"`` and ``"dots_no_batch"`` do the same under a
    selective-checkpoint policy that saves the outputs of every product
    (``dots``) or of the products without batch dims (``dots_no_batch``)
    and recomputes the rest, as ``jax.checkpoint_policies``'
    ``dots_saveable`` and ``dots_with_no_batch_dims_saveable`` do (see
    :data:`_BATCH_PRODUCTS` for the custom ops); ``None`` or ``"none"``
    keeps every activation."""
    check_remat_policy(remat_policy)
    periods = params["periods"]
    aux = None
    for i, kind in enumerate(cfg.prelude):
        c = caches["prelude"][i] if caches is not None else None
        x, _, a = _block_apply(cfg, kind, params[f"prelude{i}"], x,
                               positions=positions, cache=c,
                               cache_pos=cache_pos)
        aux = _add_aux(aux, a)
    remat = remat_policy not in (None, "none") and caches is None
    kw = {}
    if remat_policy in _SAVED:
        kw["context_fn"] = partial(_remat_contexts, _SAVED[remat_policy])
    for n in range(cfg.num_periods):
        pp = periods[n] if isinstance(periods, list) else _at(periods, n)
        pc = _at(caches["periods"], n) if caches is not None else None
        if remat:
            x, a = checkpoint(_period_apply, cfg, pp, x, positions, None,
                              cache_pos, use_reentrant=False, **kw)
        else:
            x, a = _period_apply(cfg, pp, x, positions, pc, cache_pos)
        aux = _add_aux(aux, a)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if aux is None:
        aux = x.new_zeros((), dtype=torch.float32)
    return x, caches, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed caches: a list for the prelude and the stacked
    ``(num_periods, batch, max_len, ...)`` leaves for the periods (KV
    heads and head dim for attention, the latent or the rope key for
    MLA)."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg)
    prelude = [_block_cache_init(cfg, kind, batch, max_len, dt, dev)
               for kind in cfg.prelude]
    one = {f"b{i}": _block_cache_init(cfg, kind, batch, max_len, dt, dev)
           for i, kind in enumerate(cfg.block_pattern)}
    periods = tree_map(
        lambda t: t.new_zeros((cfg.num_periods,) + t.shape), one)
    return {"prelude": prelude, "periods": periods}


# ------------------------------------------------------------------- loss
def chunked_cross_entropy(cfg: ModelConfig, hidden: torch.Tensor,
                          head_w: torch.Tensor, targets: torch.Tensor,
                          chunk: int = 8192) -> torch.Tensor:
    """Mean next-token cross entropy that never builds (B, S, V) logits
    (port of the reference's ``chunked_cross_entropy``): the T = B·S
    tokens are cut into n equal chunks, n the largest count <= T / chunk
    that divides T, and each chunk's vocab projection, log-sum-exp and
    target logit are taken in turn (a Python loop where the reference
    scans). Vocab-padding logits are masked; targets < 0 are ignored.
    Returns the float32 scalar ``loss_sum / max(count, 1)``."""
    B, S, D = hidden.shape
    T = B * S
    h = hidden.reshape(T, D)
    t = targets.reshape(T).long()
    n = max(T // chunk, 1)
    while T % n:
        n -= 1
    # split, not sliced or indexed: the backward of a slice or a select
    # is a zero tensor of the whole input's shape per chunk
    mode, h = _head_split(cfg, h, head_w)
    chunks = [(h, t)] if n == 1 else list(zip(h.split(T // n),
                                              t.split(T // n)))
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for hx, tx in chunks:
        if mode == "vocab":
            lse, tgt = _vocab_parallel_ce(cfg, hx, head_w, tx)
        else:
            logits = (hx @ head_w).float()                       # (c, V)
            if mode == "rows":
                logits = L.model_mesh().reduce_from(logits, "model")
            logits = mask_pad_logits(cfg, logits)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, tx.clamp(min=0)[:, None]).squeeze(-1)
        valid = (tx >= 0).float()
        loss_sum = loss_sum + ((lse - tgt) * valid).sum()
        count = count + valid.sum()
    return loss_sum / count.clamp(min=1.0)


def _head_split(cfg: ModelConfig, h: torch.Tensor, head_w: torch.Tensor):
    """(mode, the hidden states the head reads) under
    :func:`layers.model_mesh`: ``"vocab"`` where ``head_w``'s columns are
    this rank's block of V, ``"rows"`` where its rows are the rank's
    block of D (a tied table; the hidden states cut to it), else
    ``"whole"``. Split, the hidden states enter it through *f*."""
    mesh = L.model_mesh()
    if mesh is None or tuple(head_w.shape) == (cfg.d_model,
                                               cfg.padded_vocab):
        return "whole", h
    h = mesh.copy_to(h, "model")
    if head_w.shape[1] < cfg.padded_vocab:
        return "vocab", h
    Dl = head_w.shape[0]
    return "rows", h.narrow(-1, mesh.axis_index("model") * Dl, Dl)


def _vocab_parallel_ce(cfg: ModelConfig, hx, head_w, tx):
    """(lse, target logit) of the tokens ``hx`` from this rank's columns
    ``head_w`` of the vocab: pad columns masked by their global index,
    the log-sum-exp from the ``pmax`` of the rows' maxima and the psum of
    the exponentials, the target logit from the rank that holds it."""
    mesh = L.model_mesh()
    Vl = head_w.shape[1]
    v0 = mesh.axis_index("model") * Vl
    logits = (hx @ head_w).float()                               # (c, Vl)
    if cfg.padded_vocab != cfg.vocab_size:
        cols = torch.arange(v0, v0 + Vl, device=logits.device)
        logits = torch.where(cols < cfg.vocab_size, logits, float("-inf"))
    mx = mesh.pmax(logits.detach().amax(-1), "model")
    se = mesh.reduce_from(torch.exp(logits - mx[:, None]).sum(-1), "model")
    own = (tx >= v0) & (tx < v0 + Vl)
    mine = logits.gather(-1, (tx - v0).clamp(0, Vl - 1)[:, None])
    tgt = mesh.reduce_from(torch.where(own, mine.squeeze(-1), 0.0), "model")
    return torch.log(se) + mx, tgt


def loss_fn(cfg: ModelConfig, params, batch: dict,
            remat_policy: str | None = None):
    """Training loss (port of the reference's ``loss_fn``). ``batch``:
    ``tokens`` (B, S) int or ``embeds`` (B, S, D), and ``targets`` (B, S).
    Returns ``(ce + router_aux_weight · aux, {"ce", "aux"})``: ``aux``
    is :func:`forward`'s sum of the MoE blocks' load-balancing losses,
    0 for a config without experts (whose loss is ``ce`` alone).
    ``remat_policy`` as for :func:`forward`."""
    x = embed_inputs(cfg, params, batch)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    hidden, _, aux = forward(cfg, params, x, positions=positions,
                             remat_policy=remat_policy)
    ce = chunked_cross_entropy(cfg, hidden, lm_head_weight(cfg, params),
                               batch["targets"])
    loss = ce + cfg.moe.router_aux_weight * aux if cfg.moe else ce
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------- serving
def _logits(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    """Float32 logits (..., V), pad columns masked; under tensor
    parallelism the ranks' vocab blocks all-gathered, or the tied
    table's partial products psummed."""
    w = lm_head_weight(cfg, params)
    mode, hidden = _head_split(cfg, hidden, w)
    logits = L.linear(hidden, w).float()
    if mode == "vocab":
        logits = L.model_mesh().gather_from(logits, "model", -1)
    elif mode == "rows":
        logits = L.model_mesh().reduce_from(logits, "model")
    return mask_pad_logits(cfg, logits)


def prefill(cfg: ModelConfig, params, batch: dict, max_len: int):
    """Run the prompt, fill caches of length ``max_len``. Returns
    (last_logits (B,1,V) float32, caches)."""
    x = embed_inputs(cfg, params, batch)
    B, S = x.shape[:2]
    caches = init_cache(cfg, B, max_len, x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    hidden, caches, _ = forward(cfg, params, x, positions=positions,
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
    hidden, caches, _ = forward(cfg, params, x, positions=positions,
                                caches=caches, cache_pos=0)
    rows = torch.arange(B, device=x.device)
    last = hidden[rows, plens.to(x.device).long() - 1][:, None]  # (B,1,D)
    return _logits(cfg, params, last), caches


def encoder_logits(cfg: ModelConfig, params, batch: dict) -> torch.Tensor:
    """Encoder-only (HuBERT): full-sequence logits (B, S, V) float32 for
    masked prediction, with no cache. ``batch``: ``embeds`` (B, S, D)
    or ``tokens`` (B, S)."""
    x = embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    hidden, _, _ = forward(cfg, params, x, positions=positions)
    return _logits(cfg, params, hidden)


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
    hidden, caches, _ = forward(cfg, params, x, positions=positions,
                                caches=caches, cache_pos=cache_pos)
    return _logits(cfg, params, hidden), caches


__all__ = ["REMAT_POLICIES", "check_remat_policy", "chunked_cross_entropy",
           "decode_step", "embed_inputs", "encoder_logits", "forward",
           "init_cache", "init_params", "lm_head_weight", "loss_fn",
           "mask_pad_logits", "prefill", "prefill_batched",
           "unstack_periods"]
