"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's ``repro.models.moe.apply_moe``, on the same seeded numpy
weights and activations.

Tolerances: 1e-4 on outputs and the aux loss in float32 and 2e-4 on the
gradients (XLA and PyTorch sum products in other orders); in bfloat16
the routing is held where the 2nd / 3rd probability margin exceeds 2^-7
and the outputs to tests/test_kernels.py's bf16 tolerance (5e-2)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
MARGIN = 2.0 ** -7


def _configs(**moe):
    """The reduced mixtral in both packages, the MoE fields overridden."""
    jc = jcfg.reduced(jcfg.get_config("mixtral-8x7b"))
    tc = tcfg.reduced(tcfg.get_config("mixtral-8x7b"))
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def _weights(jc, seed, dtype="float32"):
    """Reference-initialised MoE weights (numpy), the expert stacks cast
    to ``dtype`` (the router stays float32, as in the reference)."""
    jc = dataclasses.replace(jc, dtype=dtype)
    p = jmoe.moe_init(jc, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, p)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _both(jc, tc, wp, x_np, dtype="float32"):
    jp = jax.tree_util.tree_map(jnp.asarray, wp)
    tp = params_from_numpy(wp, "cpu")
    jx = jnp.asarray(x_np).astype(dtype)
    tx = torch.from_numpy(x_np).to(getattr(torch, dtype))
    jout, jaux = jmoe.apply_moe(jc, jp, jx)
    tout, taux = tmoe.apply_moe(tc, tp, tx)
    return jout, jaux, tout, taux, tp, tx


@pytest.mark.parametrize("case, moe, shape", [
    ("reduced capacity factor 2.0", {}, (2, 24, 64)),
    ("capacity drops", {"capacity_factor": 0.5}, (2, 32, 64)),
    ("G > 1", {}, (2, 1024, 64)),
    ("G > 1 with drops", {"capacity_factor": 0.5}, (4, 512, 64)),
    ("shared expert", {"num_shared_experts": 1}, (2, 24, 64)),
    ("top-1 of 8", {"num_experts": 8, "experts_per_token": 1}, (3, 8, 64)),
    # deepseek-v2-lite's routing: top-6, two shared experts
    ("top-6 of 16, two shared", {"num_experts": 16, "experts_per_token": 6,
                                 "num_shared_experts": 2}, (2, 24, 64)),
    ("top-6 of 16, two shared, drops",
     {"num_experts": 16, "experts_per_token": 6, "num_shared_experts": 2,
      "capacity_factor": 0.5}, (2, 32, 64)),
])
def test_apply_moe_matches_reference(case, moe, shape):
    jc, tc = _configs(**moe)
    wp = _weights(jc, seed=1)
    x_np = _x(shape, seed=2)
    jout, jaux, tout, taux, tp, tx = _both(jc, tc, wp, x_np)
    assert tout.shape == tuple(shape) and tout.dtype == torch.float32
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    T = shape[0] * shape[1]
    dropped = tmoe.dropped_share(tc, tp["router"], tx)
    if "drops" in case:
        assert dropped > 0.05, f"no assignment dropped ({dropped})"
    else:
        assert dropped == 0.0
    if T > 1024:
        assert T // min(1024, T) > 1


def test_apply_moe_gradient_matches_jax_grad():
    """d/d(params, x) of sum(out * w) + 0.3 aux, with drops."""
    jc, tc = _configs(capacity_factor=0.75)
    wp = _weights(jc, seed=3)
    x_np = _x((2, 32, 64), seed=4)
    w = np.random.default_rng(5).standard_normal((2, 32, 64),
                                                 dtype=np.float32)

    def jloss(p, x):
        out, aux = jmoe.apply_moe(jc, p, x)
        return jnp.sum(out * w) + 0.3 * aux
    jp = jax.tree_util.tree_map(jnp.asarray, wp)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x_np))
    tp = {k: v.requires_grad_() for k, v in
          params_from_numpy(wp, "cpu").items()}
    tx = torch.from_numpy(x_np).requires_grad_()
    out, aux = tmoe.apply_moe(tc, tp, tx)
    (out * torch.from_numpy(w)).sum().add(0.3 * aux).backward()
    assert tmoe.dropped_share(tc, tp["router"].detach(), tx.detach()) > 0
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x),
                               **GRAD_TOL)
    assert sorted(tp) == sorted(jg_p)
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg_p[k]),
                                   err_msg=k, **GRAD_TOL)


def _reference_routing(jc, router, x):
    """top_e and the sorted probabilities of the reference's router on
    groups of x (its own lines: the product in x's dtype, then float32)."""
    B, S, D = x.shape
    T = B * S
    N = min(1024, T)
    xg = x.reshape(T // N, N, D)
    logits = (xg @ jnp.asarray(router).astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, jc.moe.experts_per_token)
    return np.asarray(top_e), np.sort(np.asarray(probs), -1)[..., ::-1]


@pytest.mark.parametrize("shape", [(2, 24, 64), (2, 1024, 64)])
def test_apply_moe_bfloat16(shape):
    """bf16 weights and activations: the routing equal wherever the
    2nd / 3rd probability margin exceeds 2^-7, and the outputs of the
    tokens routed alike within the bf16 tolerance."""
    jc, tc = _configs()
    jc = dataclasses.replace(jc, dtype="bfloat16")
    tc = dataclasses.replace(tc, dtype="bfloat16")
    wp = _weights(jc, seed=6, dtype="bfloat16")
    x_np = _x(shape, seed=7)
    jout, jaux, tout, taux, tp, tx = _both(jc, tc, wp, x_np, "bfloat16")
    assert tout.dtype == torch.bfloat16
    j_top, j_sorted = _reference_routing(jc, wp["router"],
                                         jnp.asarray(x_np).astype(
                                             jnp.bfloat16))
    N = min(1024, shape[0] * shape[1])
    _, _, t_top, _, _ = tmoe.route(tc, tp["router"],
                                   tx.reshape(-1, N, shape[-1]))
    clear = (j_sorted[..., 1] - j_sorted[..., 2]) > MARGIN
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(t_top.numpy()[clear], j_top[clear])
    alike = (t_top.numpy() == j_top).all(-1).reshape(shape[:2])
    assert alike.mean() > 0.9
    got = tout.float().numpy()[alike]
    want = np.asarray(jout.astype(jnp.float32))[alike]
    np.testing.assert_allclose(got, want, **BF16_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **BF16_TOL)


def test_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: both
    packages pick experts 0 and 1, as ``jax.lax.top_k`` orders ties."""
    jc, tc = _configs()
    wp = _weights(jc, seed=8)
    wp["router"] = np.zeros_like(wp["router"])
    x_np = _x((1, 8, 64), seed=9)
    j_top, _ = _reference_routing(jc, wp["router"], jnp.asarray(x_np))
    _, _, t_top, _, _ = tmoe.route(tc, torch.from_numpy(wp["router"]),
                                   torch.from_numpy(x_np))
    assert (j_top == [0, 1]).all()
    np.testing.assert_array_equal(t_top.numpy(), j_top)
    jout, jaux, tout, taux, _, _ = _both(jc, tc, wp, x_np)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("full, n, want", [
    (False, 8, 8), (False, 1024, 1024), (False, 1, 2),
    (True, 8, 4), (True, 1, 2), (True, 1024, 320)])
def test_capacity(full, n, want):
    """C = min(max(ceil(N·K/E · cf), 4), N·K): at the reduced config (E 4,
    K 2, cf 2.0) C = N; at mixtral's (E 8, K 2, cf 1.25) a decode step of
    8 rows has 4 slots for its 16 assignments, a lone token 2 for 2."""
    tc = tcfg.get_config("mixtral-8x7b") if full else _configs()[1]
    assert tmoe.capacity(tc, n) == want


def test_tokens_not_a_multiple_of_the_group_are_refused():
    _, tc = _configs()
    wp = params_from_numpy(_weights(_configs()[0], seed=10), "cpu")
    x = torch.zeros((3, 500, 64))
    with pytest.raises(ValueError, match="not a multiple of the group"):
        tmoe.apply_moe(tc, wp, x)


def test_mixtral_config_matches_reference():
    """Registered field for field as the reference registers it, at the
    reference's 46.7 B parameters."""
    j = jcfg.get_config("mixtral-8x7b")
    t = tcfg.get_config("mixtral-8x7b")
    for f in j.__dataclass_fields__:
        a, b = getattr(j, f), getattr(t, f)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f
    assert t.param_count() == j.param_count()
    assert abs(t.param_count() / 46.7e9 - 1) < 0.01
    assert t.block_pattern == ("swa_moe",) and t.num_layers == 32
