"""The port's copy of the ParDNN partitioner and its plan artifact against
the JAX reference's: the same graphs give the same assignment, bit for
bit, with the same makespan and peaks, and a plan saved by either
package loads in the other."""
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro.api as japi  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import modelgraphs as jmg  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import errors as terr  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import modelgraphs as tmg  # noqa: E402
from repro_torch.core import partitioner as tpart  # noqa: E402


def _random_pair(seed: int):
    """The same random DAG built by each package."""
    rng = np.random.default_rng(seed)
    kw = dict(n=int(rng.integers(20, 200)),
              avg_deg=float(rng.uniform(0.5, 3.0)), seed=seed,
              frac_residual=float(rng.uniform(0.0, 0.3)))
    jg, tg = jgraph.random_dag(**kw), tgraph.random_dag(**kw)
    assert jg.fingerprint() == tg.fingerprint()
    return jg, tg


def _assert_same(jp, tp):
    assert np.array_equal(np.asarray(jp.assignment),
                          np.asarray(tp.assignment))
    assert jp.makespan == tp.makespan
    assert np.array_equal(np.asarray(jp.peak_mem), np.asarray(tp.peak_mem))
    assert (jp.feasible, jp.moved_nodes) == (tp.feasible, tp.moved_nodes)


@pytest.mark.parametrize("engine", ["vector", "scalar"])
@pytest.mark.parametrize("capped", [False, True], ids=["free", "tight"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("seed", range(20))
def test_random_dag_partition_matches_reference(seed, k, capped, engine,
                                                monkeypatch):
    # both packages read the Step-2 engine from the same switch
    monkeypatch.setenv("REPRO_STEP2_ENGINE", engine)
    jg, tg = _random_pair(seed)
    caps = None
    if capped:
        free = jpart.pardnn_partition(jg, k)
        caps = float(max(free.peak_mem)) * 0.8 / 0.9
    jp = jpart.pardnn_partition(jg, k, mem_caps=caps)
    tp = tpart.pardnn_partition(tg, k, mem_caps=caps)
    assert tpart.PardnnOptions().engine is None
    _assert_same(jp, tp)


MODEL_GRAPHS = {
    "word_rnn": dict(layers=2, hidden=256, seq=4, batch=4, vocab=1000),
    "char_crn": dict(layers=2, hidden=256, seq=4),
    "wrn": dict(residual_units=4, widen=2),
    "trn": dict(layers=2, d_model=256, d_ff=512, heads=4, seq=16,
                vocab=1000),
    "e3d": dict(hidden=32, layers=2, seq=3, img=16),
}


@pytest.mark.parametrize("name", sorted(MODEL_GRAPHS))
def test_model_graph_partition_matches_reference(name):
    """The paper's model graphs, reduced, on the V100 model (the
    builders' default)."""
    jg = getattr(jmg, name)(**MODEL_GRAPHS[name])
    tg = getattr(tmg, name)(**MODEL_GRAPHS[name])
    assert jg.fingerprint() == tg.fingerprint() and tg.n > 50
    _assert_same(jpart.pardnn_partition(jg, 4),
                 tpart.pardnn_partition(tg, 4))
    cap = float(np.max(jpart.pardnn_partition(jg, 4).peak_mem)) * 0.7
    _assert_same(jpart.pardnn_partition(jg, 4, mem_caps=cap),
                 tpart.pardnn_partition(tg, 4, mem_caps=cap))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["rr", "topo"])
def test_baselines_match_reference(name, k):
    jg, tg = _random_pair(7)
    _assert_same(jbase.BASELINES[name](jg, k), tbase.BASELINES[name](tg, k))


def test_h100_model_and_no_tpu_constant():
    h = tcost.H100
    assert (h.peak_flops, h.hbm_bw, h.link_bw, h.hbm_bytes) == \
        (989e12, 3.35e12, 450e9, 80 * 2**30)
    assert not [n for n in dir(tcost) if "TPU" in n.upper()]
    assert tcost.V100.to_dict() == jmg.V100.to_dict()


# ---------------------------------------------------------------------------
# the plan artifact
# ---------------------------------------------------------------------------
def _plan(seed=3, k=4):
    _, tg = _random_pair(seed)
    return tapi.partition(tg, devices=k, memory=1e9,
                          meta={"arch": "random", "seed": seed}), tg


def test_plan_save_load_round_trip(tmp_path):
    plan, tg = _plan()
    path = plan.save(str(tmp_path / "p.plan.json"))
    back = tapi.PartitionPlan.load(path, graph=tg)
    assert np.array_equal(back.assignment, plan.assignment)
    assert back.assignment.dtype == np.int64
    assert back.report.to_dict() == json.loads(
        json.dumps(plan.report.to_dict()))
    assert np.array_equal(back.peak_mem, plan.peak_mem)
    assert (back.k, back.fingerprint, back.meta) == \
        (plan.k, plan.fingerprint, plan.meta)
    assert list(back.names) == list(plan.names)
    assert back.devices.memory == 1e9
    assert "PartitionPlan: " in back.summary()


def test_plan_refuses_unknown_schema(tmp_path):
    plan, _ = _plan()
    path = plan.save(str(tmp_path / "p.plan.json"))
    with open(path) as f:
        header = json.load(f)
    header["schema_version"] = 99
    with open(path, "w") as f:
        json.dump(header, f)
    with pytest.raises(terr.PlanValidationError) as e:
        tapi.PartitionPlan.load(path)
    assert e.value.code == terr.RP101_SCHEMA_UNKNOWN


def test_plan_refuses_corrupted_payload(tmp_path):
    plan, _ = _plan()
    path = plan.save(str(tmp_path / "p.plan.json"))
    npz = str(tmp_path / "p.plan.npz")
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["assignment"][0] = (arrays["assignment"][0] + 1) % plan.k
    with open(npz, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(terr.PlanValidationError) as e:
        tapi.PartitionPlan.load(path)
    assert e.value.code == terr.RP103_PAYLOAD_CORRUPT


def test_plan_refuses_another_graph(tmp_path):
    plan, _ = _plan(seed=3)
    path = plan.save(str(tmp_path / "p.plan.json"))
    _, other = _random_pair(4)
    with pytest.raises(terr.PlanValidationError) as e:
        tapi.PartitionPlan.load(path, graph=other)
    assert e.value.code == terr.RP102_FINGERPRINT_MISMATCH
    loaded = tapi.PartitionPlan.load(path)
    with pytest.raises(terr.PlanValidationError) as e:
        loaded.bind(tapi.TracedModel(other, None, other.fingerprint()))
    assert e.value.code == terr.RP102_FINGERPRINT_MISMATCH


def test_plans_load_across_packages(tmp_path):
    jg, tg = _random_pair(5)
    tplan = tapi.partition(tg, devices=4, meta={"by": "port"})
    jplan = japi.partition(jg, devices=4, meta={"by": "reference"})
    assert np.array_equal(tplan.assignment, jplan.assignment)
    tpath = tplan.save(str(tmp_path / "port.plan.json"))
    jpath = jplan.save(str(tmp_path / "ref.plan.json"))
    # the port's plan in the reference, the reference's in the port
    a = japi.PartitionPlan.load(tpath, graph=jg)
    b = tapi.PartitionPlan.load(jpath, graph=tg)
    for loaded, src in ((a, tplan), (b, jplan)):
        assert np.array_equal(loaded.assignment, src.assignment)
        assert loaded.fingerprint == src.fingerprint
        assert loaded.makespan == src.makespan
        assert np.array_equal(loaded.peak_mem, src.peak_mem)
        assert loaded.meta == src.meta


def test_device_spec_and_fold_device_map():
    import torch
    devs = [torch.device("cpu")] * 2
    spec = tapi.DeviceSpec.resolve(devs, memory=[1e9, 2e9])
    assert (spec.count, spec.torch_devices) == (2, devs)
    assert np.array_equal(spec.mem_caps(), [1e9, 2e9])
    assert tapi.DeviceSpec.resolve(4, memory=5e8).mem_caps() == 5e8
    assert tapi.fold_device_map(4, devices=devs) == [0, 1, 0, 1]
    assert tapi.fold_device_map(2, devices=devs) is None
    if not torch.cuda.is_available():
        # the default is every CUDA device; there is none to fold onto
        with pytest.raises(RuntimeError):
            tapi.fold_device_map(4)
