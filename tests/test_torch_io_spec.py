"""The port's shape table, skip rules and abstract inputs against the
JAX reference, for every registered config.

``input_specs`` in the reference returns ``jax.ShapeDtypeStruct`` leaves
from ``jax.eval_shape``; the port's are tensors on the ``meta`` device.
These tests hold each leaf to the reference's shape and dtype, for every
config and every entry of ``SHAPES`` that the skip rules keep, and the
registry, ``ASSIGNED_ARCHS``, ``param_count`` and ``smoke_batch`` to the
reference's. Nothing here allocates a full-size tensor: both sides only
record shapes.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.models import io_spec  # noqa: E402

ARCHS = sorted(jcfg.REGISTRY)
SHAPE_NAMES = list(jcfg.SHAPES)


def _assert_specs_match(want, got):
    """Every leaf of the reference's tree at the same key path in the
    port's tree, a meta tensor of the same shape and dtype, and no leaf
    more."""
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for path, leaf in leaves:
        node = got
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        where = jax.tree_util.keystr(path)
        assert isinstance(node, torch.Tensor), where
        assert node.device.type == "meta", where
        assert tuple(node.shape) == tuple(leaf.shape), where
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), where


def test_registry_and_assigned_archs_match():
    assert sorted(tcfg.REGISTRY) == sorted(jcfg.REGISTRY)
    assert tcfg.ASSIGNED_ARCHS == jcfg.ASSIGNED_ARCHS
    assert set(tcfg.ASSIGNED_ARCHS) <= set(tcfg.REGISTRY)
    assert {k: tuple(v.__dict__.items()) for k, v in tcfg.SHAPES.items()} \
        == {k: tuple(v.__dict__.items()) for k, v in jcfg.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches(arch):
    assert tcfg.get_config(arch).param_count() == \
        jcfg.get_config(arch).param_count()


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match(arch, shape):
    """The skip rule's verdict, word for word, and where the cell runs,
    every abstract input of its step."""
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    js, ts = jcfg.SHAPES[shape], tcfg.SHAPES[shape]
    reason = tcfg.shape_skip_reason(tc, ts)
    assert reason == jcfg.shape_skip_reason(jc, js)
    if reason is not None:
        return
    from repro.models.io_spec import input_specs
    _assert_specs_match(input_specs(jc, js), tm.input_specs(tc, ts))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_spec_matches(arch):
    """The full-size parameter tree on ``meta``: the reference's
    ``eval_shape`` of ``init_params``, leaf for leaf."""
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    _assert_specs_match(jm.params_spec(jc), tm.params_spec(tc))


def test_cache_spec_matches_at_a_small_size():
    jc = jcfg.get_config("internvl2-1b")
    tc = tcfg.get_config("internvl2-1b")
    _assert_specs_match(jm.cache_spec(jc, 3, 40), io_spec.cache_spec(tc, 3,
                                                                     40))


@pytest.mark.parametrize("arch", ["granite-8b", "internvl2-1b",
                                  "hubert-xlarge"])
def test_smoke_batch_matches(arch):
    """Zeros of the reference's shapes and dtypes: tokens, or a stubbed
    frontend's float32 embeddings, and targets."""
    want = jm.smoke_batch(jcfg.get_config(arch), batch=3, seq=5)
    got = tm.smoke_batch(tcfg.get_config(arch), batch=3, seq=5,
                         device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
