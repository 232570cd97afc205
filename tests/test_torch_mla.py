"""The port's Multi-head Latent Attention (``repro_torch.models.layers.
apply_mla``) and deepseek-v2-lite-16b against the JAX reference, on the
same bridged weights and seeded numpy inputs.

Tolerances: 1e-4 (atol = rtol) in float32, as the model tests (XLA and
PyTorch sum products in other orders); in bfloat16 none: on the same
bf16 inputs the two packages round at the same points (the latent's
float32 norm cast to bf16, ``q_lat``, the probabilities, ``o_lat``, the
output) and agree bit for bit on the CPU. A port that keeps any one of
those in float32 moves the outputs by up to 0.72 of one bf16 step of
their largest magnitude, which a gate of that size would let through.
The engines are held to the reference's in ``test_torch_serving.py``."""
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
import repro_torch.serving as ts  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.astype(jnp.float32) if hasattr(x, "astype")
                        else x, dtype=np.float32)


def _configs(dtype="float32"):
    jc = dataclasses.replace(jcfg.reduced(jcfg.get_config(ARCH)),
                             dtype=dtype)
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_config(ARCH)),
                             dtype=dtype)
    return jc, tc


def _layer(jc, seed):
    """One MLA layer's reference weights, as JAX arrays and port tensors."""
    wp = jax.tree_util.tree_map(np.asarray,
                                jL.mla_init(jc, jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(jnp.asarray, wp), \
        params_from_numpy(wp, "cpu")


def _x(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return jnp.asarray(x).astype(dtype), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def test_reduced_config_has_mla_and_mla_moe():
    jc, tc = _configs()
    assert tc.prelude == ("mla",) and tc.block_pattern == ("mla_moe",)
    assert tc.num_layers == 2 and tc.kv_lora_rank == 16
    assert (tc.qk_nope_dim, tc.qk_rope_dim, tc.v_head_dim) == (16, 8, 16)
    for f in jc.__dataclass_fields__:
        a, b = getattr(jc, f), getattr(tc, f)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f


def test_deepseek_config_matches_reference():
    """Registered field for field as the reference registers it, at the
    reference's 15.7 B parameters."""
    j, t = jcfg.get_config(ARCH), tcfg.get_config(ARCH)
    for f in j.__dataclass_fields__:
        a, b = getattr(j, f), getattr(t, f)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f
    assert t.param_count() == j.param_count()
    assert abs(t.param_count() / 15.7e9 - 1) < 0.01
    assert t.num_layers == 27 and t.num_periods == 26
    assert (t.moe.num_experts, t.moe.experts_per_token,
            t.moe.num_shared_experts, t.moe.d_ff) == (64, 6, 2, 1408)


def test_apply_mla_training_branch_matches_reference():
    jc, tc = _configs()
    jp, tp = _layer(jc, 1)
    jx, tx = _x((2, 21, jc.d_model), 2)
    pos = np.arange(21, dtype=np.int32)
    jo, jcache = jL.apply_mla(jc, jp, jx, positions=jnp.asarray(pos))
    to, tcache = tL.apply_mla(tc, tp, tx, positions=torch.from_numpy(pos))
    assert jcache is None and tcache is None
    assert to.shape == (2, 21, jc.d_model) and to.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)


def test_training_branch_pads_v_to_the_query_width(monkeypatch):
    """The training branch hands attention q and k at nope + rope and v
    at its own v_head_dim, unpadded, as the reference does (the name
    is the test's from when v was zero-padded to the query width; the
    op now takes v at its own width). The flash op's scale is
    1/sqrt(nope + rope) as in the reference."""
    _, tc = _configs()
    jc, _ = _configs()
    _, tp = _layer(jc, 3)
    _, tx = _x((1, 10, tc.d_model), 4)
    seen = []
    inner = tL.multi_head_attention

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return inner(q, k, v, **kw)
    monkeypatch.setattr(tL, "multi_head_attention", spy)
    tL.apply_mla(tc, tp, tx, positions=torch.arange(10))
    (q, k, v), = seen
    qk = tc.qk_nope_dim + tc.qk_rope_dim
    assert q.shape == k.shape == (1, 10, tc.num_heads, qk)
    assert v.shape == (1, 10, tc.num_heads, tc.v_head_dim) and \
        tc.v_head_dim < qk
    # the rope key is one per position, shared by the heads
    assert torch.equal(k[:, :, :1, tc.qk_nope_dim:].expand_as(
        k[..., tc.qk_nope_dim:]), k[..., tc.qk_nope_dim:])


def test_apply_mla_prefill_matches_reference():
    """With a cache longer than the prompt: the absorbed branch, and
    both cache leaves written at [0, S)."""
    jc, tc = _configs()
    jp, tp = _layer(jc, 5)
    jx, tx = _x((2, 13, jc.d_model), 6)
    pos = np.arange(13, dtype=np.int32)
    jcache = jL.mla_cache_init(jc, 2, 24, jnp.float32)
    tcache = tL.mla_cache_init(tc, 2, 24, torch.float32, "cpu")
    assert {k: v.shape for k, v in jcache.items()} == \
        {k: tuple(v.shape) for k, v in tcache.items()} == \
        {"c_kv": (2, 24, 16), "k_rope": (2, 24, 8)}
    jo, jnew = jL.apply_mla(jc, jp, jx, positions=jnp.asarray(pos),
                            kv_cache=jcache, cache_pos=0)
    to, tnew = tL.apply_mla(tc, tp, tx, positions=torch.from_numpy(pos),
                            kv_cache=tcache, cache_pos=0)
    assert tnew is tcache, "the cache is written in place"
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(tnew[name]), _np(jnew[name]),
                                   err_msg=name, **TOL)
        assert not tnew[name][:, 13:].any(), name


def test_apply_mla_decode_per_row_positions_matches_reference():
    """One token per row, each row at its own position: the mask is
    key position <= cache_pos[b], the cache leaves written at it."""
    jc, tc = _configs()
    jp, tp = _layer(jc, 7)
    rng = np.random.default_rng(8)
    cache = {"c_kv": rng.standard_normal((3, 20, 16), dtype=np.float32),
             "k_rope": rng.standard_normal((3, 20, 8), dtype=np.float32)}
    jcache = jax.tree_util.tree_map(jnp.asarray, cache)
    tcache = params_from_numpy(cache, "cpu")
    jx, tx = _x((3, 1, jc.d_model), 9)
    cpos = np.array([4, 17, 0], np.int32)
    positions = cpos.reshape(-1, 1)
    jo, jnew = jL.apply_mla(jc, jp, jx, positions=jnp.asarray(positions),
                            kv_cache=jcache, cache_pos=jnp.asarray(cpos))
    to, tnew = tL.apply_mla(tc, tp, tx,
                            positions=torch.from_numpy(positions),
                            kv_cache=tcache,
                            cache_pos=torch.from_numpy(cpos))
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(tnew[name]), _np(jnew[name]),
                                   err_msg=name, **TOL)
    # only the row's own position changed
    changed = (tnew["c_kv"] != torch.from_numpy(cache["c_kv"])).any(-1)
    assert changed.nonzero().tolist() == [[0, 4], [1, 17], [2, 0]]


@pytest.mark.parametrize("branch", ["training", "prefill", "decode"])
def test_apply_mla_bfloat16(branch):
    """bf16 weights and activations in all three uses: the output and
    the bf16 cache leaves equal to the reference's, bit for bit."""
    jc, tc = _configs("bfloat16")
    jp, tp = _layer(jc, 10)
    assert tp["kv_norm"].dtype == torch.float32
    assert tp["wq"].dtype == torch.bfloat16
    S = 1 if branch == "decode" else 17
    jx, tx = _x((2, S, jc.d_model), 11, "bfloat16")
    kw_j, kw_t = {}, {}
    if branch == "training":
        pos = np.arange(S, dtype=np.int32)
    else:
        rng = np.random.default_rng(12)
        c = {"c_kv": rng.standard_normal((2, 24, 16), dtype=np.float32),
             "k_rope": rng.standard_normal((2, 24, 8), dtype=np.float32)}
        if branch == "prefill":
            c = jax.tree_util.tree_map(np.zeros_like, c)
        cpos = np.array([9, 20], np.int32) if branch == "decode" else 0
        pos = (cpos.reshape(-1, 1) if branch == "decode"
               else np.arange(S, dtype=np.int32))
        kw_j = dict(kv_cache=jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).astype(jnp.bfloat16), c),
            cache_pos=jnp.asarray(cpos))
        kw_t = dict(kv_cache={k: torch.from_numpy(v).bfloat16()
                              for k, v in c.items()},
                    cache_pos=(torch.from_numpy(cpos)
                               if branch == "decode" else 0))
    jo, jnew = jL.apply_mla(jc, jp, jx, positions=jnp.asarray(pos), **kw_j)
    to, tnew = tL.apply_mla(tc, tp, tx, positions=torch.from_numpy(pos),
                            **kw_t)
    assert to.dtype == torch.bfloat16
    pairs = [("out", to, jo)]
    if branch != "training":
        pairs += [(n, tnew[n], jnew[n]) for n in ("c_kv", "k_rope")]
        assert all(tnew[n].dtype == torch.bfloat16 for n in tnew)
    for name, got, want in pairs:
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_params_round_trip_bit_exact(dtype):
    """The MLA + MoE tree crosses both ways unchanged: ``kv_norm`` and the
    router float32, the shared experts and the prelude's dense MLP in
    the compute dtype, the prelude a dict of its own beside the stacked
    periods."""
    jc, _ = _configs(dtype)
    ref = jax.tree_util.tree_map(np.asarray,
                                 jm.init_params(jc, jax.random.PRNGKey(0)))
    port = params_from_numpy(ref, "cpu")
    back = params_to_numpy(port)
    ref_l = jax.tree_util.tree_leaves_with_path(ref)
    back_l = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(ref_l) == len(back_l) == len(jax.tree_util.tree_leaves(port))
    mix = port["periods"]["b0"]["mix"]
    assert sorted(mix) == ["kv_norm", "w_dkv", "w_kr", "w_uk", "w_uv", "wo",
                           "wq"]
    assert mix["kv_norm"].dtype == torch.float32
    assert mix["wq"].dtype == getattr(torch, dtype)
    ffn = port["periods"]["b0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert {"shared_up", "shared_gate", "shared_down"} <= set(ffn)
    assert sorted(port["prelude0"]["ffn"]) == ["w_down", "w_gate", "w_up"]
    assert port["prelude0"]["mix"]["w_dkv"].shape == (jc.d_model, 16)
    for path, a in ref_l:
        b = back_l[path]
        assert b.dtype == a.dtype and b.shape == a.shape, path
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                      err_msg=jax.tree_util.keystr(path))


def test_deepseek_pools_are_three_dimensional_latent_leaves():
    """The paged pools hold MLA's cache as two 3-D leaves a layer, the
    latent (blocks, block, r) and the shared rope key (blocks, block,
    rope): a list for the prelude, stacked over the periods."""
    _, tc = _configs()
    pools = ts.init_pools(tc, 10, 4, "cpu")
    assert sorted(pools["prelude"][0]["mix"]) == ["c_kv", "k_rope"]
    assert tuple(pools["prelude"][0]["mix"]["c_kv"].shape) == (10, 4, 16)
    assert tuple(pools["periods"]["b0"]["mix"]["c_kv"].shape) == \
        (1, 10, 4, 16)
    assert tuple(pools["periods"]["b0"]["mix"]["k_rope"].shape) == \
        (1, 10, 4, 8)
