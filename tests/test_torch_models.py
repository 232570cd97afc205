"""The port's dense model path against the JAX reference, in float32 on
bridged weights.

Tolerance atol = rtol = 1e-4: XLA and PyTorch sum matrix products in
different orders, and the difference grows through the layers."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each keeps the parallel test workers from
# contending for the cores
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.models.layers as jL  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.models.layers as tL  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["deepseek-v2-lite-16b", "gemma3-1b", "granite-8b",
         "hubert-xlarge", "internvl2-1b", "jamba-v0.1-52b", "mixtral-8x7b",
         "qwen2.5-14b", "repro-lm-100m", "starcoder2-7b"]
#: the archs whose first period block is a GQA layer
GQA_ARCHS = [a for a in ARCHS
             if a not in ("deepseek-v2-lite-16b", "jamba-v0.1-52b")]
#: the archs with a cache, a prefill and a decode step (hubert-xlarge is
#: encoder-only)
CACHE_ARCHS = [a for a in ARCHS if a != "hubert-xlarge"]
#: the archs whose every cache leaf has a sequence axis to grow
#: (jamba's mamba caches hold a conv window and a state)
SEQ_CACHE_ARCHS = [a for a in CACHE_ARCHS if a != "jamba-v0.1-52b"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    name = request.param
    jc = jcfg.reduced(jcfg.get_config(name), layers=2)
    tc = tcfg.reduced(tcfg.get_config(name), layers=2)
    for f in jc.__dataclass_fields__:
        want, got = getattr(jc, f), getattr(tc, f)
        if dataclasses.is_dataclass(want):
            want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert want == got, f
    jp = jm.init_params(jc, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _prompts(cfg, seed=0, plens=(5, 8, 3)):
    rng = np.random.default_rng(seed)
    S = max(plens)
    tokens = np.zeros((len(plens), S), np.int32)
    for i, n in enumerate(plens):
        tokens[i, :n] = rng.integers(1, cfg.vocab_size, n)
    return tokens, np.asarray(plens, np.int32)


def _assert_tree_close(a, b, **tol):
    ja = jax.tree_util.tree_leaves_with_path(a)
    assert len(ja) > 0
    for path, leaf in ja:
        node = b
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(_np(node), np.asarray(leaf), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("model", CACHE_ARCHS, indirect=True)
def test_prefill_batched_logits_and_caches_match(model):
    jc, tc, jp, tp = model
    tokens, plens = _prompts(jc)
    jl, jcache = jm.prefill_batched(jc, jp, jnp.asarray(tokens),
                                    jnp.asarray(plens))
    tl, tcache = tm.prefill_batched(tc, tp, torch.from_numpy(tokens),
                                    torch.from_numpy(plens))
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _assert_tree_close(jcache, tcache, **TOL)


@pytest.mark.parametrize("model", SEQ_CACHE_ARCHS, indirect=True)
def test_decode_step_per_row_positions_match(model):
    jc, tc, jp, tp = model
    tokens, plens = _prompts(jc, seed=1)
    _, jcache = jm.prefill_batched(jc, jp, jnp.asarray(tokens),
                                   jnp.asarray(plens))
    # grow the dense caches so every row has room for one more token: the
    # sequence axis is 1 in the prelude's leaves and 2 in the stacked
    # periods' (the leaves are 4-D and 5-D for GQA, 3-D and 4-D for MLA)
    def grow(path, c):
        axis = 2 if jax.tree_util.keystr(path).startswith("['periods']") \
            else 1
        return jnp.pad(c, [(0, 4) if i == axis else (0, 0)
                           for i in range(c.ndim)])
    jcache = jax.tree_util.tree_map_with_path(grow, jcache)
    tcache = params_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                               "cpu")
    nxt = np.random.default_rng(2).integers(
        1, jc.vocab_size, (len(plens), 1)).astype(np.int32)
    jl, jcache2 = jm.decode_step(jc, jp, jcache, jnp.asarray(nxt),
                                 jnp.asarray(plens))
    tl, tcache2 = tm.decode_step(tc, tp, tcache, torch.from_numpy(nxt),
                                 torch.from_numpy(plens))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _assert_tree_close(jcache2, tcache2, **TOL)


@pytest.mark.parametrize("model", CACHE_ARCHS, indirect=True)
def test_sequential_prefill_then_decode_match(model):
    jc, tc, jp, tp = model
    prompt = np.random.default_rng(3).integers(1, jc.vocab_size, (1, 6))
    prompt = prompt.astype(np.int32)
    jl, jcache = jm.prefill(jc, jp, {"tokens": jnp.asarray(prompt)}, 16)
    tl, tcache = tm.prefill(tc, tp, {"tokens": torch.from_numpy(prompt)}, 16)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    tok = np.array([[7]], np.int32)
    jl, _ = jm.decode_step(jc, jp, jcache, jnp.asarray(tok), 6)
    tl, _ = tm.decode_step(tc, tp, tcache, torch.from_numpy(tok), 6)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)


@pytest.mark.parametrize("model", GQA_ARCHS, indirect=True)
@pytest.mark.parametrize("is_global,S", [(True, 12), (False, 24)])
def test_apply_gqa_matches(model, is_global, S):
    """One attention layer on its own; the sliding-window case runs a
    sequence longer than the reduced config's window of 16."""
    jc, tc, jp, tp = model
    layer_j = jax.tree_util.tree_map(lambda a: a[0],
                                     jp["periods"]["b0"]["mix"])
    layer_t = {k: v[0] for k, v in tp["periods"]["b0"]["mix"].items()}
    x = np.random.default_rng(4).standard_normal(
        (2, S, jc.d_model), dtype=np.float32)
    pos = np.arange(S, dtype=np.int32)
    jo, _ = jL.apply_gqa(jc, layer_j, jnp.asarray(x),
                         positions=jnp.asarray(pos), is_global=is_global)
    to, _ = tL.apply_gqa(tc, layer_t, torch.from_numpy(x),
                         positions=torch.from_numpy(pos),
                         is_global=is_global)
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_matches(model, dtype):
    jc, tc, _, _ = model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, jc.d_model), dtype=np.float32) * 3
    p = {"scale": rng.standard_normal(jc.d_model, dtype=np.float32)}
    if jc.norm == "layernorm":
        p["bias"] = rng.standard_normal(jc.d_model, dtype=np.float32)
    jo = jL.apply_norm(jc, {k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x).astype(dtype))
    to = tL.apply_norm(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x).to(getattr(torch, dtype)))
    assert to.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(to.float()),
                               np.asarray(jo.astype(jnp.float32)), **tol)


def test_init_params_tree_matches_reference(model):
    """``init_params`` draws other numbers than jax.random, but the tree,
    shapes and dtypes are the reference's."""
    jc, tc, jp, _ = model
    own = tm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    own_flat = dict(jax.tree_util.tree_leaves_with_path(own))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = own_flat[path]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert len(own_flat) == len(jax.tree_util.tree_leaves(jp))


def test_other_block_kinds_are_refused():
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"))
    cfg = cfg.__class__(**{**cfg.__dict__, "block_pattern": ("hyena",)})
    with pytest.raises(NotImplementedError, match="hyena"):
        tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("arch, published", [("gemma3-1b", 1.0e9),
                                             ("qwen2.5-14b", 14.7e9),
                                             ("starcoder2-7b", 7.2e9)])
def test_dense_config_matches_reference(arch, published):
    """Registered field for field as the reference registers it, with the
    reference's parameter count, which tests/test_configs.py holds within
    18% of the published size."""
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    for f in j.__dataclass_fields__:
        a, b = getattr(j, f), getattr(t, f)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f
    assert t.param_count() == j.param_count()
    assert abs(t.param_count() / published - 1) < 0.18


def _embeds(cfg, seed, B, S):
    """Patch or frame embeddings as a stubbed frontend hands them over."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
            * 0.1)


@pytest.mark.parametrize("model", ["hubert-xlarge"], indirect=True)
def test_encoder_logits_match(model):
    """The encoder-only path: every position's logits from frame
    embeddings, non-causal attention, layernorm and a plain GELU MLP."""
    jc, tc, jp, tp = model
    assert tc.encoder_only and not tc.causal
    x = _embeds(jc, 6, 2, 12)
    jl = jm.encoder_logits(jc, jp, {"embeds": jnp.asarray(x)})
    tl = tm.encoder_logits(tc, tp, {"embeds": torch.from_numpy(x)})
    assert tl.shape == jl.shape == (2, 12, tc.padded_vocab)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)


@pytest.mark.parametrize("model", ["internvl2-1b"], indirect=True)
def test_prefill_from_embeds_then_decode_from_tokens_match(model):
    """The VLM's use: patch-and-prompt embeddings in, every cache leaf
    filled, then greedy text decoding fed tokens."""
    jc, tc, jp, tp = model
    x = _embeds(jc, 7, 2, 9)
    jl, jcache = jm.prefill(jc, jp, {"embeds": jnp.asarray(x)}, 16)
    tl, tcache = tm.prefill(tc, tp, {"embeds": torch.from_numpy(x)}, 16)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _assert_tree_close(jcache, tcache, **TOL)
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for pos in (9, 10):
        jl, jcache = jm.decode_step(jc, jp, jcache, jnp.asarray(tok), pos)
        tl, tcache = tm.decode_step(tc, tp, tcache, torch.from_numpy(tok),
                                    pos)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(
            np.int32)[:, None]
    _assert_tree_close(jcache, tcache, **TOL)


@pytest.mark.parametrize("arch", ["internvl2-1b", "hubert-xlarge"])
def test_frontend_config_matches_reference(arch):
    """The two configs with a stubbed frontend, registered field for
    field as the reference registers them, with its parameter count."""
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    for f in j.__dataclass_fields__:
        assert getattr(j, f) == getattr(t, f), f
    assert t.param_count() == j.param_count()
    assert t.frontend is not None and t.source == j.source



@pytest.mark.parametrize("arch, words", [
    ("internvl2-1b", "non-token frontend has no token prompts to serve"),
    ("hubert-xlarge", "encoder-only arch has no decode step"),
])
def test_paged_serving_refuses_frontend_configs(arch, words):
    """The paged engine refuses both, with the reference's words: the
    VLM serves through ``prefill`` from embeddings and ``decode_step``,
    the encoder through ``encoder_logits``."""
    from repro.serving.kvcache import supported_reason as jax_reason
    from repro_torch.serving.kvcache import supported_reason
    want = jax_reason(jcfg.get_config(arch))
    assert supported_reason(tcfg.get_config(arch)) == want == words
