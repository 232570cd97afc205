"""The port's pipeline planners (``repro_torch.pipeline.pardnn_pp``)
against the reference's (``repro.pipeline.pardnn_pp``) on the CPU:
``config_stage_plan`` for every registered config at 2, 4 and 8 stages;
``plan_stages`` on random chains (hypothesis), with and without a memory
cap; ``uniform_plan``; ``plan_stages_emulated`` on the same stage graph;
``stack_stage_params`` on the same layer stacks; and
``PartitionPlan.to_pipeline_stages`` of plans of the same graph.
Boundaries, stage memory and feasibility must be equal; the bottleneck
(a sum of float64 costs) within 1e-12 relative."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.configs as jcfg  # noqa: E402
import repro.core.graph as jgraph  # noqa: E402
import repro.pipeline.pardnn_pp as jpp  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.pipeline import pardnn_pp as tpp  # noqa: E402

#: relative tolerance of the bottleneck: the same float64 sums, in the
#: same order, in both packages
REL = 1e-12


def _same(got, want):
    assert got.boundaries == [tuple(b) for b in want.boundaries]
    assert got.stage_mem == want.stage_mem
    assert got.feasible == want.feasible
    assert got.layers_per_stage == want.layers_per_stage
    if np.isinf(want.bottleneck):
        assert np.isinf(got.bottleneck)
    else:
        assert got.bottleneck == pytest.approx(want.bottleneck, rel=REL)


@pytest.mark.parametrize("stages", [2, 4, 8])
@pytest.mark.parametrize("arch", sorted(jcfg.REGISTRY))
def test_config_stage_plan_equals_reference(arch, stages):
    assert sorted(tcfg.REGISTRY) == sorted(jcfg.REGISTRY)
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    kinds = list(tc.prelude) + list(tc.block_pattern) * tc.num_periods
    for k in sorted(set(kinds)):
        assert tpp.layer_flops(tc, k, 1e6) == jpp.layer_flops(jc, k, 1e6)
    _same(tpp.config_stage_plan(tc, stages),
          jpp.config_stage_plan(jc, stages))
    # a cap that binds: half the model per stage
    cap = 2.0 * tc.param_count() / stages
    _same(tpp.config_stage_plan(tc, stages, mem_cap=cap),
          jpp.config_stage_plan(jc, stages, mem_cap=cap))


def test_config_stage_plan_granite_four_stages():
    plan = tpp.config_stage_plan(tcfg.get_config("granite-8b"), 4)
    assert plan.boundaries == [(0, 9), (9, 18), (18, 27), (27, 36)]
    assert plan.feasible


def _plan_stages_case(costs, mem_scale, stages, act, cap, inflight):
    mems = [c * mem_scale % 17.0 + 1.0 for c in costs]
    kw = dict(act_bytes=act, num_stages=stages, mem_cap=cap,
              inflight=inflight)
    got = tpp.plan_stages(costs, mems, **kw)
    want = jpp.plan_stages(costs, mems, **kw)
    _same(got, want)
    if got.feasible:
        assert got.boundaries[0][0] == 0
        assert got.boundaries[-1][1] == len(costs)


@pytest.mark.parametrize("cap", [None, 30.0, 2.0])
def test_plan_stages_equals_reference_on_a_chain(cap):
    costs = np.random.default_rng(5).uniform(0.1, 9.0, 17).tolist()
    _plan_stages_case(costs, 3.0, 4, 1.5, cap, None)


def test_plan_stages_equals_reference_hypothesis():
    """Random chains, with and without a cap (hypothesis)."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=60, deadline=None)
    @hyp.given(costs=st.lists(st.floats(0.01, 100.0), min_size=1,
                              max_size=24),
               mem_scale=st.floats(0.5, 50.0), stages=st.integers(1, 9),
               act=st.floats(0.0, 5.0),
               cap=st.one_of(st.none(), st.floats(1.0, 400.0)),
               inflight=st.one_of(st.none(), st.integers(1, 4)))
    def check(costs, mem_scale, stages, act, cap, inflight):
        _plan_stages_case(costs, mem_scale, stages, act, cap, inflight)

    check()


@pytest.mark.parametrize("L, stages", [(1, 1), (7, 3), (36, 4), (27, 8),
                                       (8, 8), (48, 5)])
def test_uniform_plan_equals_reference(L, stages):
    got = tpp.uniform_plan(L, stages)
    assert got == jpp.uniform_plan(L, stages)
    assert sum(e - s for s, e in got) == L


def _chain(mod, costs):
    g = mod.CostGraph()
    ids = [g.add_node(comp=float(c), name=f"l{i}")
           for i, c in enumerate(costs)]
    for a, b in zip(ids, ids[1:]):
        g.add_edge(a, b, comm=1e-6)
    return g.finalize()


@pytest.mark.parametrize("micro", [1, 4, 9])
def test_plan_stages_emulated_equals_reference(micro):
    rng = np.random.default_rng(micro)
    costs = rng.uniform(0.5, 3.0, 20).tolist()
    mems = rng.uniform(1.0, 2.0, 20).tolist()
    plan_t = tpp.plan_stages(costs, mems, act_bytes=0.1, num_stages=4)
    plan_j = jpp.plan_stages(costs, mems, act_bytes=0.1, num_stages=4)
    got = tpp.plan_stages_emulated(_chain(tgraph, costs), plan_t, micro)
    want = jpp.plan_stages_emulated(_chain(jgraph, costs), plan_j, micro)
    assert got == pytest.approx(want, rel=REL)
    # the GPipe fill and drain: at least one pass through every stage and
    # the bottleneck once a microbatch
    assert got >= max(sum(costs) / 4, plan_t.bottleneck * micro) - 1e-9


@pytest.mark.parametrize("bounds", [[(0, 3), (3, 5), (5, 9)],
                                    [(0, 1), (1, 9)], [(0, 9)]])
def test_stack_stage_params_equals_reference(bounds):
    rng = np.random.default_rng(3)
    layers = {"w": rng.standard_normal((9, 4, 3)).astype(np.float32),
              "b": {"v": rng.standard_normal((9, 5)).astype(np.float32)}}
    got, mask = tpp.stack_stage_params(
        {"w": torch.from_numpy(layers["w"]),
         "b": {"v": torch.from_numpy(layers["b"]["v"])}}, bounds)
    want, jmask = jpp.stack_stage_params(
        {"w": jnp.asarray(layers["w"]), "b": {"v": jnp.asarray(
            layers["b"]["v"])}}, bounds)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"]["v"].numpy(),
                                  np.asarray(want["b"]["v"]))


@pytest.mark.parametrize("memory, stages", [(None, None), (60.0, None),
                                            ([50.0, 70.0, 40.0], 2)])
def test_to_pipeline_stages_equals_reference(memory, stages):
    rng = np.random.default_rng(11)
    costs = rng.uniform(0.5, 3.0, 12)
    g_t, g_j = _chain(tgraph, costs), _chain(jgraph, costs)
    plan_t = api.partition(g_t, devices=3, memory=memory)
    plan_j = japi.partition(g_j, devices=3, memory=memory)
    layer_costs = rng.uniform(1.0, 2.0, 12).tolist()
    layer_mem = rng.uniform(1.0, 9.0, 12).tolist()
    got = plan_t.to_pipeline_stages(layer_costs, layer_mem, 2.0,
                                    num_stages=stages)
    want = plan_j.to_pipeline_stages(layer_costs, layer_mem, 2.0,
                                     num_stages=stages)
    _same(got, want)
    assert len(got.boundaries) == (stages or 3)
