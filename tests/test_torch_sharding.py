"""The port's sharding rules and mesh shapes (``repro_torch.sharding.rules``,
``repro_torch.launch.mesh``) against the reference's on the CPU: for
every registered config on the 16x16 and 2x16x16 meshes of
``tests/test_sharding.py`` (the reference's mesh built as
``AbstractMesh(axis_sizes, axis_names)``), the port's per-dimension axis
tuples equal ``tuple(spec)`` of the reference's ``PartitionSpec``s, leaf
for leaf, exactly: ``param_specs`` and ``zero1_specs`` over
``params_spec``'s shapes; ``batch_specs`` and ``cache_specs`` of every
shape ``shape_skip_reason`` admits, with and without ``long_context``;
``activation_plan`` for train, prefill, decode and decode_long; and the
mesh functions and ``rules_total_dp``."""
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro.launch.mesh as jmesh  # noqa: E402
import repro.models.io_spec as jio  # noqa: E402
import repro.train.step as jstep  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import io_spec as tio  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402
from repro_torch.train import rules_total_dp  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model"), False),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}
ARCHS = sorted(jcfg.REGISTRY)


def _meshes(name):
    sizes, names, multi = MESHES[name]
    return AbstractMesh(sizes, names), tmesh.make_production_mesh(
        multi_pod=multi)


def _ref_leaves(tree) -> list[tuple]:
    """``tuple(spec)`` of every spec (or NamedSharding) leaf, in
    ``tree_leaves`` order."""
    out = []
    for x in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, P)):
        out.append(tuple(x if isinstance(x, P) else x.spec))
    return out


def test_registries_agree():
    assert ARCHS == sorted(tcfg.REGISTRY) and len(ARCHS) == 11


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_equal_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    jp, tp = jio.params_spec(jcfg.get_config(arch)), \
        tio.params_spec(tcfg.get_config(arch))
    js = jrules.param_specs(jp, jm)
    ts = trules.param_specs(tp, tm)
    got = trules.spec_leaves(ts, tp)
    assert got == _ref_leaves(js) and len(got) == len(
        jax.tree_util.tree_leaves(jp))
    assert trules.spec_leaves(trules.zero1_specs(ts, tp, tm), tp) == \
        _ref_leaves(jrules.zero1_specs(js, jp, jm))


def _admitted(arch):
    jc = jcfg.get_config(arch)
    return [s for s in jcfg.SHAPES
            if jcfg.shape_skip_reason(jc, jcfg.SHAPES[s]) is None]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    shapes = _admitted(arch)
    assert shapes == [s for s in tcfg.SHAPES if tcfg.shape_skip_reason(
        tc, tcfg.SHAPES[s]) is None]
    for s in shapes:
        jspec = jio.input_specs(jc, jcfg.SHAPES[s])
        tspec = tio.input_specs(tc, tcfg.SHAPES[s])
        jb = jspec.get("batch", {k: v for k, v in jspec.items()
                                 if k != "caches"})
        tb = tspec.get("batch", {k: v for k, v in tspec.items()
                                 if k != "caches"})
        for lc in (False, True):
            got = trules.spec_leaves(
                trules.batch_specs(tm, tb, long_context=lc), tb)
            assert got == _ref_leaves(
                jrules.batch_specs(jm, jb, long_context=lc)), (s, lc)
            if "caches" not in tspec:
                continue
            tcache = tspec["caches"]
            got = trules.spec_leaves(
                trules.cache_specs(tm, tcache, long_context=lc), tcache)
            want = _ref_leaves(jrules.cache_specs(jm, jspec["caches"],
                                                  long_context=lc))
            assert got == want and got, (s, lc)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_plan_equals_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    for kind in ("train", "prefill", "decode", "decode_long"):
        want = {k: tuple(v.spec) for k, v in jrules.activation_plan(
            jm, jcfg.get_config(arch), kind=kind).items()}
        assert trules.activation_plan(tm, tcfg.get_config(arch),
                                      kind=kind) == want and want, kind
    assert trules.activation_plan(tm, None, kind="train") == {
        k: tuple(v.spec) for k, v in jrules.activation_plan(
            jm, None, kind="train").items()}


def test_spec_cases_of_the_reference_suite():
    """The reference's own cases (``tests/test_sharding.py``)."""
    tm = tmesh.make_production_mesh()
    specs = trules.param_specs(tio.params_spec(tcfg.get_config(
        "deepseek-v2-lite-16b")), tm)
    assert specs["periods"]["b0"]["ffn"]["w_up"] == (None, "model", None,
                                                     None)
    specs = trules.param_specs(tio.params_spec(tcfg.get_config(
        "mixtral-8x7b")), tm)
    assert specs["periods"]["b0"]["ffn"]["w_up"] == (None, None, None,
                                                     "model")
    specs = trules.param_specs(tio.params_spec(tcfg.get_config(
        "internvl2-1b")), tm)
    assert specs["embed"] == (None, "model")
    blk = trules.param_specs(tio.params_spec(tcfg.get_config(
        "granite-8b")), tm)["periods"]["b0"]
    assert blk["mix"]["wq"] == (None, None, "model")
    assert blk["mix"]["wo"] == (None, "model", None)
    assert trules.batch_axes(tmesh.make_production_mesh(
        multi_pod=True)) == ("pod", "data")
    assert trules.batch_axes(tm) == ("data",)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_functions_equal_reference(mesh):
    jm, tm = _meshes(mesh)
    assert tm.shape == dict(jm.shape)
    assert list(tm.shape) == list(jm.shape)
    assert tmesh.mesh_num_chips(tm) == jmesh.mesh_num_chips(jm)
    assert rules_total_dp(tm) == jstep.rules_total_dp(jm)
    assert trules.batch_axes(tm) == jrules.batch_axes(jm)


def test_host_mesh_on_the_cpu():
    host = tmesh.make_host_mesh(device="cpu")
    ref = jmesh.make_host_mesh(data=1, model=1)
    assert host.shape == dict(ref.shape) == {"data": 1, "model": 1}
    assert tmesh.mesh_num_chips(host) == 1 and rules_total_dp(host) == 1
    assert tmesh.host_device_count("cpu") == 1
    with pytest.raises(ValueError, match="does not fit"):
        tmesh.make_host_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tmesh.make_host_mesh(model=1, pod=2, device="cpu")
    assert tmesh.MeshShape((1, 1, 1), ("pod", "data", "model")).shape == \
        {"pod": 1, "data": 1, "model": 1}
    with pytest.raises(ValueError):
        tmesh.MeshShape((2,), ("data", "model"))


def test_host_mesh_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is there")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_host_mesh()
