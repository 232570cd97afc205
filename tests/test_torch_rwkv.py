"""The port's rwkv6-7b model path against the JAX reference: reduced
config, 2 layers, float32, on bridged weights.

Tolerance atol = rtol = 1e-4, as for the dense model (test_torch_models):
XLA and PyTorch sum matrix products in other orders, and the port's
recurrence runs in another chunking than the reference's
``_wkv_chunked`` (fixed chunks of 64 with a padded tail, against equal
chunks that divide S), so the two differ by float32 rounding that grows
through the layers."""
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
import repro.models.transformer as jt  # noqa: E402
import repro.models.rwkv as jrwkv  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.models.rwkv as trwkv  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels.rwkv6 import ops  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "rwkv6-7b"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             "cpu")


@pytest.fixture(scope="module")
def model():
    jc = jcfg.reduced(jcfg.get_config(ARCH), layers=2)
    tc = tcfg.reduced(tcfg.get_config(ARCH), layers=2)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.block_pattern == ("rwkv",) and tc.num_periods == 2
    jp = jm.init_params(jc, jax.random.PRNGKey(1))
    return jc, tc, jp, _bridge(jp)


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)


def _assert_tree_close(a, b, **tol):
    ja = jax.tree_util.tree_leaves_with_path(a)
    assert len(ja) > 0
    for path, leaf in ja:
        node = b
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_allclose(_np(node), np.asarray(leaf), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_config_matches_reference():
    jc, tc = jcfg.get_config(ARCH), tcfg.get_config(ARCH)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    # the analytic count is the reference's, w_g and cm_r left out
    assert tc.param_count() == jc.param_count()


@pytest.mark.parametrize("S", [12, 64, 70])
def test_forward_matches(model, S):
    jc, tc, jp, tp = model
    tokens = _tokens(jc, 2, S, seed=S)
    jx = jt.embed_inputs(jc, jp, {"tokens": jnp.asarray(tokens)})
    jh, _, _ = jt.forward(jc, jp, jx, positions=jnp.arange(S))
    tx = tm.embed_inputs(tc, tp, {"tokens": torch.from_numpy(tokens)})
    th, _, _ = tm.forward(tc, tp, tx, positions=torch.arange(S))
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)


def test_prefill_logits_and_every_cache_leaf_match(model):
    jc, tc, jp, tp = model
    tokens = _tokens(jc, 3, 20, seed=1)
    jl, jcache = jm.prefill(jc, jp, {"tokens": jnp.asarray(tokens)}, 32)
    tl, tcache = tm.prefill(tc, tp, {"tokens": torch.from_numpy(tokens)},
                            32)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _assert_tree_close(jcache, tcache, **TOL)


def _prefilled(model, seed, B=2, S=10):
    jc, tc, jp, tp = model
    tokens = _tokens(jc, B, S, seed)
    _, jcache = jm.prefill(jc, jp, {"tokens": jnp.asarray(tokens)}, 32)
    return jcache, _bridge(jcache), S


def test_decode_step_matches(model):
    jc, tc, jp, tp = model
    jcache, tcache, pos = _prefilled(model, seed=2)
    nxt = _tokens(jc, 2, 1, seed=3)
    jl, jcache2 = jm.decode_step(jc, jp, jcache, jnp.asarray(nxt), pos)
    before = ops.wkv6.launches
    tl, tcache2 = tm.decode_step(tc, tp, tcache, torch.from_numpy(nxt), pos)
    assert ops.wkv6.launches == before
    assert tcache2 is tcache        # written in place
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _assert_tree_close(jcache2, tcache2, **TOL)


def test_prefill_with_state_matches(model):
    """decode_step with several tokens: the recurrence seeded from the
    cached state (the reference's chunked path with ``state0``)."""
    jc, tc, jp, tp = model
    jcache, tcache, pos = _prefilled(model, seed=4)
    more = _tokens(jc, 2, 7, seed=5)
    jl, jcache2 = jm.decode_step(jc, jp, jcache, jnp.asarray(more), pos)
    tl, tcache2 = tm.decode_step(tc, tp, tcache, torch.from_numpy(more),
                                 pos)
    assert tl.shape == jl.shape == (2, 7, jc.padded_vocab)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _assert_tree_close(jcache2, tcache2, **TOL)


def test_decode_equals_full_forward(model):
    """The port on its own: prefill, then one token at a time, gives the
    last-position logits of one prefill over the whole sequence, and the
    same state."""
    _, tc, _, tp = model
    tokens = torch.from_numpy(_tokens(tc, 2, 16, seed=6))
    full, full_cache = tm.prefill(tc, tp, {"tokens": tokens}, 16)
    logits, cache = tm.prefill(tc, tp, {"tokens": tokens[:, :9]}, 16)
    for t in range(9, 16):
        logits, cache = tm.decode_step(tc, tp, cache, tokens[:, t:t + 1], t)
    np.testing.assert_allclose(_np(logits), _np(full), **TOL)
    np.testing.assert_allclose(
        _np(cache["periods"]["b0"]["tm"]["S"]),
        _np(full_cache["periods"]["b0"]["tm"]["S"]), **TOL)


@pytest.mark.parametrize("S", [12, 70])
def test_timemix_matches(model, S):
    """One time-mix layer on its own, without a cache."""
    jc, tc, jp, tp = model
    layer_j = jax.tree_util.tree_map(lambda a: a[0], jp["periods"]["b0"]["tm"])
    layer_t = {k: v[0] for k, v in tp["periods"]["b0"]["tm"].items()}
    x = np.random.default_rng(7).standard_normal((2, S, jc.d_model),
                                                 dtype=np.float32)
    jo, _ = jrwkv.apply_rwkv_timemix(jc, layer_j, jnp.asarray(x))
    to, _ = trwkv.apply_rwkv_timemix(tc, layer_t, torch.from_numpy(x))
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)


def test_init_params_tree_matches_reference(model):
    """``init_params`` draws other numbers than jax.random, but the tree,
    shapes and dtypes are the reference's (``w0``, ``u``, ``ln_x`` in
    float32), at the reduced and the full width."""
    jc, tc, jp, _ = model
    own = tm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    own_flat = dict(jax.tree_util.tree_leaves_with_path(own))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = own_flat[path]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert len(own_flat) == len(jax.tree_util.tree_leaves(jp))
    tm_p = own["periods"]["b0"]["tm"]
    assert float(tm_p["w0"][0, 0]) == -6.0
    assert abs(float(tm_p["w_lora_b"].std()) - 0.01) < 0.005


def test_paged_serving_still_refuses_rwkv(model):
    """The recurrent state has no sequence axis to page: the paged engine
    refuses rwkv in both packages."""
    from repro_torch.serving import ServingEngine
    _, tc, _, tp = model
    with pytest.raises(NotImplementedError, match="recurrent"):
        ServingEngine(tc, tp, device="cpu")
