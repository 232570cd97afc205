"""Model building blocks: norms, RoPE, the MLP, GQA and Multi-head
Latent Attention (port of ``repro.models.layers``).

Conventions, as in the reference:
  * params are nested dicts of tensors; weights are (in, out), applied
    as ``x @ W``;
  * activations: x is (B, S, D); attention heads (B, S, H, hd);
  * norms, RoPE and softmax run in float32 and cast back to x's dtype.

**Tensor parallelism.** The reference marks layout boundaries with
``shard(x, kind)`` (``with_sharding_constraint`` under the plan that
:func:`activation_sharding` installs) and lets XLA insert the
collectives. The port has no compiler to do that: under
:func:`activation_sharding` with a :class:`~repro_torch.distributed.
ProcessMesh` whose ``model`` axis is above 1, each rank computes with its
blocks of the parameters, as ``rules.param_specs`` stores them, and calls
the collectives itself (Megatron's layout, explicit SPMD): a layer reads
which tensors are split from their shapes against the config's. Where a
stored block does not hold whole heads (or the rules' divisibility test
left a layout that has no split product), the layer gathers it over
``model`` (:func:`whole`) and computes that part on every rank.
:func:`shard` itself computes nothing: it records each kind it sees.

Where to put *f*: at a block's input when every path from it runs split
compute (attention, MLA, the RWKV time mix, Mamba), and then each whole
tensor that the block reads before its split products (the q/k norms,
MLA's latent projections) gets the ranks' partial gradients summed by
:func:`whole` with ``split``; right before the split product where a
whole branch reads the same input (the RWKV channel mix's ``cm_r``),
since *f* at the input would sum that branch's whole gradient ``model``
times. A layer with a cache (serving over a mesh) raises under a
``model`` axis above 1 (:data:`CACHE_PENDING`).
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, torch_dtype
from ..kernels.flash_attention import ops as fops
# The decode path (one query token) is the plain attention of the
# reference, which was never a Pallas kernel; the kernel's plain version
# is that same function.
from ..kernels.flash_attention.ref import flash_attention_ref as _plain_gqa


# ------------------------------------------------------ the sharding plan
#: the plan :func:`activation_sharding` installed: ``{"plan", "mesh",
#: "kinds"}``, or None
_ACT: dict | None = None


@contextlib.contextmanager
def activation_sharding(plan: dict, mesh):
    """Install ``plan`` (``rules.activation_plan`` of the mesh) and the
    :class:`~repro_torch.distributed.ProcessMesh` ``mesh`` for the block;
    yields the list :func:`shard` appends each kind it sees to. With a
    ``model`` axis above 1 the layers run tensor parallel over it (the
    module's docstring)."""
    global _ACT
    old = _ACT
    _ACT = {"plan": plan, "mesh": mesh, "kinds": []}
    try:
        yield _ACT["kinds"]
    finally:
        _ACT = old


def shard(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The reference's layout boundary (``with_sharding_constraint`` by
    the plan's spec for ``kind``): ``x`` itself. Under a plan the kind is
    recorded; the collectives are the layers' own."""
    if _ACT is not None:
        _ACT["kinds"].append(kind)
    return x


def plan_value(key: str, default=None):
    """An entry of the installed plan (the reference's non-spec entries)."""
    return default if _ACT is None else _ACT["plan"].get(key, default)


def model_mesh():
    """The installed mesh when its ``model`` axis is above 1 (the layers
    then run tensor parallel over it), else None."""
    mesh = None if _ACT is None else _ACT["mesh"]
    return mesh if mesh is not None and \
        mesh.shape.get("model", 1) > 1 else None


#: what waits: serving over a mesh
CACHE_PENDING = ("a cache under a model axis above 1 (serving over a "
                 "mesh: tensor-parallel prefill and decode with "
                 "cache_specs) is ROADMAP M4.1e")


def refuse_cache(cache, block: str) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP item) for a
    ``block`` layer given a cache under :func:`model_mesh`."""
    if cache is not None and model_mesh() is not None:
        raise NotImplementedError(f"tensor-parallel {block} with a cache: "
                                  f"{CACHE_PENDING}")


@functools.lru_cache(maxsize=None)
def init_shapes(init, cfg: ModelConfig) -> dict:
    """The whole shape of each parameter ``init(cfg, generator)`` builds
    (a block's flat tree), drawn on the ``meta`` device: what
    :func:`whole` gathers a rank's block to, and what a layer compares
    its block with to see whether the rules split it. Outside any
    dispatch mode: a trace of the layer (``make_fx``) records none of
    it."""
    from torch.utils._python_dispatch import _disable_current_modes

    from .io_spec import _MetaGenerator
    with _disable_current_modes():
        tree = init(cfg, _MetaGenerator())
    return {k: tuple(t.shape) for k, t in tree.items()}


def whole(t: torch.Tensor, shape, split: bool) -> torch.Tensor:
    """The whole parameter of ``shape`` from this rank's block ``t``,
    under :func:`model_mesh`: ``t`` gathered over ``model`` along the
    dimension its block cuts (or ``t`` itself when whole). ``split``
    says whether what reads it computes a different part on each rank:
    then each rank's gradient is partial, and it is summed over
    ``model`` (reduce-scattered for a block, all-reduced for a whole
    tensor); otherwise each rank's is the whole gradient already."""
    mesh = model_mesh()
    shape = tuple(shape)
    if mesh is None or (tuple(t.shape) == shape and not split):
        return t
    if tuple(t.shape) == shape:
        return mesh.copy_to(t, "model")
    dim = next(i for i, (a, b) in enumerate(zip(t.shape, shape)) if a != b)
    return mesh.gather_from(t, "model", dim, partial=split)


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
    """The MLP; under :func:`model_mesh` with ``w_up`` split by columns
    (and so ``w_gate`` too, and ``w_down`` by rows) Megatron's: *f*, the
    rank's hidden columns, *g*. The rules split all three or none."""
    mesh = model_mesh()
    tp = mesh is not None and p["w_up"].shape[1] < cfg.d_ff
    if tp:
        x = mesh.copy_to(x, "model")
    up = linear(x, p["w_up"])
    if cfg.gated_mlp:
        up = activation(cfg, linear(x, p["w_gate"])) * up
    else:
        up = activation(cfg, up)
    up = shard(up, "btf")
    y = linear(up, p["w_down"])
    return mesh.reduce_from(y, "model") if tp else y


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


def _kv_select(t: torch.Tensor, heads: list, hd: int) -> torch.Tensor:
    """The columns (the last dim) of KV heads ``heads`` of a whole
    ``wk``, ``wv``, ``bk`` or ``bv``: a slice where they are consecutive
    and distinct, else gathered (with repeats)."""
    if heads == list(range(heads[0], heads[0] + len(heads))):
        return t.narrow(-1, heads[0] * hd, len(heads) * hd)
    idx = torch.tensor(heads, device=t.device)
    cols = (idx[:, None] * hd + torch.arange(hd, device=t.device)).flatten()
    return t.index_select(-1, cols)


def _gqa_tensor_parallel(cfg: ModelConfig, p, mesh):
    """(p, H_l, KV_l, split) for this rank of :func:`model_mesh`: the
    weights it computes with, its query and KV head counts, and whether
    they are its own heads (Megatron: *f* before, *g* after) or every
    head (``split`` False: the gathered weights, the same compute on
    every rank). With ``wq`` split by whole heads the rank takes query
    heads ``[r·H/m, (r+1)·H/m)``; the KV heads they read are its own
    block of ``wk`` and ``wv`` when ``KV % m == 0``, else gathered over
    ``model`` and selected (one per query head where the heads they read
    do not form equal groups)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    m, r = mesh.axis_size("model"), mesh.axis_index("model")
    shapes = init_shapes(gqa_init, cfg)
    split = p["wq"].shape[1] < shapes["wq"][1] and H % m == 0
    if not split:
        return ({k: whole(t, shapes[k], False) for k, t in p.items()}, H,
                KV, False)
    Hl, g = H // m, H // KV
    mine = [h // g for h in range(r * Hl, (r + 1) * Hl)]
    need = sorted(set(mine))
    if Hl % len(need) or mine != [need[i // (Hl // len(need))]
                                  for i in range(Hl)]:
        need = mine
    out = dict(p)
    for k in ("q_norm", "k_norm"):
        if k in p:
            out[k] = whole(p[k], shapes[k], True)
    own = p["wk"].shape[1] < cfg.kv_dim and KV % m == 0
    for k in ("wk", "wv", "bk", "bv"):
        if k in p and not own:
            out[k] = _kv_select(whole(p[k], shapes[k], True), need, hd)
    return out, Hl, len(need), True


def apply_gqa(cfg: ModelConfig, p, x: torch.Tensor, *, positions,
              is_global: bool, kv_cache=None, cache_pos=None):
    """GQA attention layer. Prefill/training: ``kv_cache`` None → full
    sequence. Decode: ``kv_cache = dict(k=(B,Smax,KV,hd), v=...)``,
    written in place at ``cache_pos``. Under :func:`model_mesh` (no
    cache) the rank's heads (:func:`_gqa_tensor_parallel`).

    Returns (out, kv_cache)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mesh = model_mesh()
    split = False
    refuse_cache(kv_cache, "attention")
    if mesh is not None:
        p, H, KV, split = _gqa_tensor_parallel(cfg, p, mesh)
        if split:
            x = mesh.copy_to(x, "model")
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
    q, k, v = shard(q, "bshd"), shard(k, "bskd"), shard(v, "bskd")
    window = None if is_global else cfg.sliding_window
    if kv_cache is None:
        out = multi_head_attention(q, k, v, causal=cfg.causal, window=window,
                                   q_offset=0, softcap=cfg.softcap)
    else:
        ck = update_cache(kv_cache["k"], k, cache_pos)
        cv = update_cache(kv_cache["v"], v, cache_pos)
        out = multi_head_attention(q, ck, cv, causal=True, window=window,
                                   q_offset=cache_pos, softcap=cfg.softcap)
    out = shard(out, "bshd")
    out = linear(out.reshape(B, S, H * hd), p["wo"])
    if split:
        out = mesh.reduce_from(out, "model")
    return out, kv_cache


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}

# ------------------------------------------------------------------- MLA
def mla_init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Multi-head Latent Attention (DeepSeek-V2), the reference's tree:
    K and V are compressed into a ``kv_lora_rank`` latent (``w_dkv``,
    RMS-normalised by the float32 ``kv_norm``) plus one rope key shared
    by the heads (``w_kr``); ``w_uk`` and ``w_uv`` up-project the
    latent."""
    d, dt = cfg.d_model, dtype_of(cfg)
    H, r = cfg.num_heads, cfg.kv_lora_rank
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": dense_init(generator, d, H * qk, dt),
        "w_dkv": dense_init(generator, d, r, dt),
        "w_kr": dense_init(generator, d, cfg.qk_rope_dim, dt),
        "w_uk": dense_init(generator, r, H * cfg.qk_nope_dim, dt),
        "w_uv": dense_init(generator, r, H * cfg.v_head_dim, dt),
        "wo": dense_init(generator, H * cfg.v_head_dim, d, dt),
        "kv_norm": torch.ones((r,), dtype=torch.float32,
                              device=generator.device),
    }


def _mla_tensor_parallel(cfg: ModelConfig, p, mesh):
    """(p, H_l, split) for this rank of :func:`model_mesh`: with ``wq``
    split by whole heads (``w_uk``, ``w_uv`` and ``wo`` with it) the
    rank's heads, *f* before and *g* after, and ``w_dkv``, ``w_kr`` and
    ``kv_norm`` whole, their partial gradients summed: the latent and
    the rope key are computed whole on every rank and read by its heads
    alone. Else every weight gathered and every head on every rank."""
    H, m = cfg.num_heads, mesh.axis_size("model")
    shapes = init_shapes(mla_init, cfg)
    split = p["wq"].shape[1] < shapes["wq"][1] and H % m == 0
    if not split:
        return {k: whole(t, shapes[k], False) for k, t in p.items()}, H, \
            False
    out = dict(p)
    for k in ("w_dkv", "w_kr", "kv_norm"):
        out[k] = whole(p[k], shapes[k], True)
    return out, H // m, True


def apply_mla(cfg: ModelConfig, p, x: torch.Tensor, *, positions,
              kv_cache=None, cache_pos=None):
    """MLA layer. Without a cache (training) K and V are materialised
    per head from the latent and attention runs through
    :func:`multi_head_attention` with q and k at head dim nope + rope and
    v at ``v_head_dim``, as the reference calls it (the scale 1/sqrt(nope
    + rope) is the reference's; the sm90 kernels take v at its own
    width). With a
    cache (prefill and decode) the latent ``c_kv`` (B, L, r) and the
    shared rope key (B, L, rope) are written in place at ``cache_pos``
    (an int or a per-row (B,) tensor) and attention runs in the
    absorbed form, in the latent space, as plain products: ``w_uk``
    folded into the query, scores in float32, ``w_uv`` applied after.
    The rounding points are the reference's: the latent normalised in
    float32 and cast to x's dtype, ``q_lat``, ``o_lat`` and the output
    in x's dtype, the probabilities cast to the cache's dtype. Under
    :func:`model_mesh` (no cache) the rank's heads
    (:func:`_mla_tensor_parallel`).

    Returns (out, kv_cache)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    r, nd, rd, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    mesh = model_mesh()
    split = False
    refuse_cache(kv_cache, "MLA")
    if mesh is not None:
        p, H, split = _mla_tensor_parallel(cfg, p, mesh)
        if split:
            x = mesh.copy_to(x, "model")
    q = linear(x, p["wq"]).reshape(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c = linear(x, p["w_dkv"]).float()                    # (B,S,r)
    c_kv = (c * torch.rsqrt(c.square().mean(-1, keepdim=True)
                            + cfg.norm_eps) * p["kv_norm"]).to(x.dtype)
    k_rope = linear(x, p["w_kr"]).reshape(B, S, 1, rd)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)

    if kv_cache is None:
        k_nope = linear(c_kv, p["w_uk"]).reshape(B, S, H, nd)
        v = linear(c_kv, p["w_uv"]).reshape(B, S, H, vd)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, rd)], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        out = multi_head_attention(qq, k, v, causal=cfg.causal, window=None,
                                   q_offset=0)
        out = linear(out.reshape(B, S, H * vd), p["wo"])
        return (mesh.reduce_from(out, "model") if split else out), None

    cc = update_cache(kv_cache["c_kv"], c_kv, cache_pos)
    ck = update_cache(kv_cache["k_rope"], k_rope[:, :, 0], cache_pos)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope,
                         p["w_uk"].reshape(r, H, nd))
    # bf16 products are exact in float32: upcast operands give the
    # reference's float32 scores from bf16 operands
    s_lat = torch.einsum("bshr,btr->bhst", q_lat.float(), cc.float())
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.float(), ck.float())
    s = (s_lat + s_rope) * (1.0 / math.sqrt(nd + rd))
    kp = torch.arange(cc.shape[1], device=x.device)
    qp = torch.as_tensor(cache_pos, device=x.device).reshape(-1, 1) + \
        torch.arange(S, device=x.device)                 # (B or 1, S)
    s = s.masked_fill(kp[None, None, None, :] > qp[:, None, :, None],
                      float("-inf"))
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", pr.to(cc.dtype), cc)
    out = torch.einsum("bshr,rhv->bshv", o_lat, p["w_uv"].reshape(r, H, vd))
    return linear(out.reshape(B, S, H * vd), p["wo"]), kv_cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    """The latent (B, L, r) and the shared rope key (B, L, rope)."""
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


__all__ = ["CACHE_PENDING", "activation", "activation_sharding",
           "apply_gqa", "apply_mla", "apply_mlp", "apply_norm", "apply_rope",
           "dense_init", "dtype_of", "gqa_cache_init", "gqa_init",
           "init_shapes", "linear",
           "mla_cache_init", "mla_init", "mlp_init", "model_mesh",
           "multi_head_attention", "norm_init", "plan_value", "refuse_cache",
           "rms_head_norm", "rope_freqs", "shard", "update_cache", "whole"]
