"""Weights cross between the JAX reference and the port bit-exactly."""
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

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_exact(dtype):
    cfg = dataclasses.replace(reduced(get_config("granite-8b"), layers=2),
                              dtype=dtype)
    ref = jax.tree_util.tree_map(np.asarray,
                                 init_params(cfg, jax.random.PRNGKey(0)))
    port = params_from_numpy(ref, "cpu")
    back = params_to_numpy(port)
    ref_flat, port_flat, back_flat = _flat(ref), _flat(port), _flat(back)
    assert ref_flat.keys() == port_flat.keys() == back_flat.keys()
    # the stacked period layout keeps its leading num_periods axis
    assert port["periods"]["b0"]["mix"]["wq"].shape == \
        (cfg.num_periods, cfg.d_model, cfg.q_dim)
    for key, a in ref_flat.items():
        t, b = port_flat[key], back_flat[key]
        assert isinstance(t, torch.Tensor) and tuple(t.shape) == a.shape
        assert b.dtype == a.dtype and b.shape == a.shape, key
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                      err_msg=key)
    if dtype == "bfloat16":
        assert port["embed"].dtype == torch.bfloat16
        # values, not only bits: bf16 → float32 agrees in both frameworks
        np.testing.assert_array_equal(
            port["embed"].float().numpy(),
            ref["embed"].astype(np.float32))


def test_rwkv_params_round_trip_bit_exact():
    """The rwkv tree in bf16 crosses unchanged, with its float32 leaves
    (``w0``, ``u``, ``ln_x``, the norms) kept float32."""
    cfg = dataclasses.replace(reduced(get_config("rwkv6-7b"), layers=2),
                              dtype="bfloat16")
    ref = jax.tree_util.tree_map(np.asarray,
                                 init_params(cfg, jax.random.PRNGKey(0)))
    port = params_from_numpy(ref, "cpu")
    back = params_to_numpy(port)
    ref_flat, port_flat, back_flat = _flat(ref), _flat(port), _flat(back)
    assert ref_flat.keys() == port_flat.keys() == back_flat.keys()
    dtypes = {str(t.dtype) for t in port_flat.values()}
    assert dtypes == {"torch.float32", "torch.bfloat16"}
    tm = port["periods"]["b0"]["tm"]
    assert tm["u"].dtype == tm["w0"].dtype == torch.float32
    assert tm["w_r"].dtype == torch.bfloat16
    for key, a in ref_flat.items():
        b = back_flat[key]
        assert b.dtype == a.dtype and b.shape == a.shape, key
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                      err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_round_trip_bit_exact(dtype):
    """mixtral's tree crosses both ways unchanged: the router stays
    float32 and the expert stacks keep their (layers, E, d, f) and (layers,
    E, f, d) shapes in the compute dtype."""
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b"), layers=2),
                              dtype=dtype)
    ref = jax.tree_util.tree_map(np.asarray,
                                 init_params(cfg, jax.random.PRNGKey(0)))
    port = params_from_numpy(ref, "cpu")
    back = params_to_numpy(port)
    ref_flat, port_flat, back_flat = _flat(ref), _flat(port), _flat(back)
    assert ref_flat.keys() == port_flat.keys() == back_flat.keys()
    ffn = port["periods"]["b0"]["ffn"]
    m, L = cfg.moe, cfg.num_periods
    assert sorted(ffn) == ["router", "w_down", "w_gate", "w_up"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["router"].shape == (L, cfg.d_model, m.num_experts)
    assert ffn["w_up"].shape == ffn["w_gate"].shape == \
        (L, m.num_experts, cfg.d_model, m.d_ff)
    assert ffn["w_down"].shape == (L, m.num_experts, m.d_ff, cfg.d_model)
    assert ffn["w_up"].dtype == getattr(torch, dtype)
    for key, a in ref_flat.items():
        b = back_flat[key]
        assert b.dtype == a.dtype and b.shape == a.shape, key
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                      err_msg=key)
