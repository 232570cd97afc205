"""The port's jamba-v0.1-52b model path against the JAX reference: the
reduced config (one period of 8 layers: 7 mamba, 1 attention, 4 MoE;
d_state 8, scan chunk 8), float32, on bridged weights.

Tolerance atol = rtol = 1e-4, as for the dense and rwkv models: XLA and
PyTorch sum matrix products in other orders, and the port's scan steps
token by token where the reference composes chunks, so the two differ by
float32 rounding that grows through the layers."""
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
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels.ssm import ops  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "jamba-v0.1-52b"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             "cpu")


@pytest.fixture(scope="module")
def model():
    jc = jcfg.reduced(jcfg.get_config(ARCH))
    tc = tcfg.reduced(tcfg.get_config(ARCH))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.num_layers == 8 and tc.num_periods == 1
    assert (tc.mamba.d_state, tc.mamba.chunk) == (8, 8)
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
    """Registered field for field as the reference registers it, with the
    reference's parameter count (51,448,971,264), and one period of 8:
    mamba at 7 positions, attention at index 4, MoE on the odd ones."""
    jc, tc = jcfg.get_config(ARCH), tcfg.get_config(ARCH)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.param_count() == jc.param_count() == 51_448_971_264
    assert tc.period == 8 and tc.block_pattern[4] == "attn"
    assert [k.endswith("moe") for k in tc.block_pattern] == [
        i % 2 == 1 for i in range(8)]


@pytest.mark.parametrize("S", [12, 16], ids=["ragged", "two-chunks"])
def test_forward_matches(model, S):
    """The backbone without caches (training's path), and the MoE blocks'
    aux loss summed over the layers."""
    jc, tc, jp, tp = model
    tokens = _tokens(jc, 2, S, seed=S)
    jx = jt.embed_inputs(jc, jp, {"tokens": jnp.asarray(tokens)})
    jh, _, jaux = jt.forward(jc, jp, jx, positions=jnp.arange(S))
    tx = tm.embed_inputs(tc, tp, {"tokens": torch.from_numpy(tokens)})
    th, _, taux = tm.forward(tc, tp, tx, positions=torch.arange(S))
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_prefill_logits_and_every_cache_leaf_match(model):
    """Every cache leaf: the mamba layers' conv windows and states and the
    attention layer's K and V."""
    jc, tc, jp, tp = model
    tokens = _tokens(jc, 3, 16, seed=1)
    jl, jcache = jm.prefill(jc, jp, {"tokens": jnp.asarray(tokens)}, 24)
    tl, tcache = tm.prefill(tc, tp, {"tokens": torch.from_numpy(tokens)},
                            24)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _assert_tree_close(jcache, tcache, **TOL)
    mix = tcache["periods"]["b0"]["mix"]
    assert set(mix) == {"conv", "h"}
    assert mix["h"].shape == (1, 3, 2 * tc.d_model, tc.mamba.d_state)


def _prefilled(model, seed, B=2, S=10):
    jc, tc, jp, tp = model
    tokens = _tokens(jc, B, S, seed)
    _, jcache = jm.prefill(jc, jp, {"tokens": jnp.asarray(tokens)}, 24)
    return jcache, _bridge(jcache), S


def test_decode_step_matches(model):
    """One token: the reference steps its recurrence; the port runs the
    same arithmetic through the scan op seeded with the cached state (on
    the CPU its plain version, not counted), writing the caches in
    place."""
    jc, tc, jp, tp = model
    jcache, tcache, pos = _prefilled(model, seed=2)
    nxt = _tokens(jc, 2, 1, seed=3)
    jl, jcache2 = jm.decode_step(jc, jp, jcache, jnp.asarray(nxt), pos)
    before = ops.selective_scan.launches
    tl, tcache2 = tm.decode_step(tc, tp, tcache, torch.from_numpy(nxt), pos)
    assert ops.selective_scan.launches == before
    assert tcache2 is tcache        # written in place
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    _assert_tree_close(jcache2, tcache2, **TOL)


def test_prefill_with_state_matches(model):
    """decode_step with several tokens: the scan seeded from the cached
    state (the reference's chunked path with ``h0``)."""
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
    same conv windows and states."""
    _, tc, _, tp = model
    tokens = torch.from_numpy(_tokens(tc, 2, 16, seed=6))
    full, full_cache = tm.prefill(tc, tp, {"tokens": tokens}, 16)
    logits, cache = tm.prefill(tc, tp, {"tokens": tokens[:, :9]}, 16)
    for t in range(9, 16):
        logits, cache = tm.decode_step(tc, tp, cache, tokens[:, t:t + 1], t)
    np.testing.assert_allclose(_np(logits), _np(full), **TOL)
    for leaf in ("conv", "h"):
        np.testing.assert_allclose(
            _np(cache["periods"]["b3"]["mix"][leaf]),
            _np(full_cache["periods"]["b3"]["mix"][leaf]), **TOL)


def test_init_params_tree_matches_reference(model):
    """``init_params`` draws other numbers than jax.random, but the tree,
    shapes and dtypes are the reference's (``dt_bias``, ``A_log`` and
    ``D`` in float32), with its S4D init of A."""
    jc, tc, jp, _ = model
    own = tm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    own_flat = dict(jax.tree_util.tree_leaves_with_path(own))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = own_flat[path]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert len(own_flat) == len(jax.tree_util.tree_leaves(jp))
    mix = own["periods"]["b0"]["mix"]
    np.testing.assert_allclose(
        _np(-torch.exp(mix["A_log"][0, 0])),
        -np.arange(1, tc.mamba.d_state + 1), rtol=1e-6)
    np.testing.assert_allclose(
        _np(torch.nn.functional.softplus(mix["dt_bias"][0, :3])), 1.0,
        rtol=1e-6)


def test_paged_serving_still_refuses_jamba(model):
    """The mamba layers' state has no sequence axis to page: the paged
    engine refuses jamba in both packages, and it is served through
    ``prefill`` / ``decode_step``."""
    from repro.serving.kvcache import supported_reason
    from repro_torch.serving import ServingEngine
    jc, tc, _, tp = model
    assert "recurrent" in supported_reason(jc)
    with pytest.raises(NotImplementedError, match="recurrent"):
        ServingEngine(tc, tp, device="cpu")
