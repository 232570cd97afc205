"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's on the CPU: ``model_flops`` for every registered arch and
shape (the reference's module runs in a child process, since importing
it sets ``XLA_FLAGS``), the roofline's dominance cases on the H100's
constants, one reduced cell of each kind, the decode cells' serve step
against the reference's, and ``--pardnn --lint`` writing a plan that
both packages load and the analysis CLI passes."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.analysis.__main__ import main as cli_main  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import REGISTRY, ShapeConfig  # noqa: E402
from repro_torch.conformance.subproc import run_py  # noqa: E402
from repro_torch.core.costmodel import (H100_HBM_BW,  # noqa: E402
                                        H100_NVLINK_BW, H100_PEAK_FLOPS)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import (init_cache, init_params,  # noqa: E402
                                io_spec, prefill)
from repro_torch.train import build_serve_step  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

#: small stand-ins for the shape table's kinds
SMALL = {"train_4k": ShapeConfig("train_4k", 32, 2, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 32, 2, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 32, 2, "decode"),
         "long_500k": ShapeConfig("long_500k", 64, 1, "decode")}


def test_model_flops_match_reference():
    out = run_py("""
        import json
        from repro.configs import REGISTRY, SHAPES
        from repro.launch.dryrun import model_flops
        print(json.dumps({f"{a} {s}": model_flops(REGISTRY[a], SHAPES[s])
                          for a in REGISTRY for s in SHAPES}))
        """, timeout=300)
    want = json.loads(out.strip().splitlines()[-1])
    got = {f"{a} {s}": dryrun.model_flops(tcfg.get_config(a),
                                          dryrun.SHAPES[s])
           for a in tcfg.REGISTRY for s in dryrun.SHAPES}
    assert got == want and len(got) == 44


def test_roofline_terms_dominance():
    """The reference's cases (``tests/test_dryrun_units.py``) on the
    H100's constants."""
    t = dryrun.roofline_terms(flops=H100_PEAK_FLOPS * 256, hbm_bytes=0,
                              coll_bytes=0, chips=256)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["dominant"] == "compute"
    t = dryrun.roofline_terms(flops=0, hbm_bytes=H100_HBM_BW * 256 * 2,
                              coll_bytes=0, chips=256)
    assert t["dominant"] == "memory" and t["bound_s"] == pytest.approx(2.0)
    t = dryrun.roofline_terms(flops=0, hbm_bytes=0,
                              coll_bytes=H100_NVLINK_BW * 256 * 3, chips=256)
    assert t["dominant"] == "collective"
    assert t["bound_s"] == pytest.approx(3.0)


@pytest.fixture
def small(monkeypatch):
    """Reduced configs registered under their own names and small
    shapes in the dry run's table."""
    for name in ("granite-8b", "hubert-xlarge", "jamba-v0.1-52b"):
        c = tcfg.get_config(name)
        monkeypatch.setitem(REGISTRY, name, dataclasses.replace(
            tcfg.reduced(c, layers=len(c.prelude) + 2 * c.period),
            name=name))
    for k, v in SMALL.items():
        monkeypatch.setitem(dryrun.SHAPES, k, v)


@pytest.mark.parametrize("arch, shape, remat", [
    ("granite-8b", "train_4k", "dots"),
    ("granite-8b", "train_4k", "dots_no_batch"),
    ("hubert-xlarge", "prefill_32k", "dots"),
    ("jamba-v0.1-52b", "decode_32k", "dots"),
    ("jamba-v0.1-52b", "long_500k", "dots"),
])
def test_reduced_cell_is_ok(small, arch, shape, remat):
    r = dryrun.run_cell(arch, shape, "single", remat=remat, device="cpu")
    assert r["status"] == "OK" and r["chips"] == 1 and r["remat"] == remat
    assert r["nodes"] > 0 and r["graph_flops"] > 0 and r["graph_bytes"] > 0
    assert r["collective_bytes"] == 0.0 and r["fits"]
    assert r["model_flops"] == dryrun.model_flops(tcfg.get_config(arch),
                                                  SMALL[shape])
    assert r["useful_flops_ratio"] == pytest.approx(
        r["model_flops"] / r["graph_flops"])
    params = sum(t.numel() * t.element_size() for t in
                 tree_flatten(io_spec.params_spec(tcfg.get_config(arch)))[0])
    assert r["per_device_total_bytes"] >= params
    rf = r["roofline"]
    assert rf["bound_s"] == max(rf["compute_s"], rf["memory_s"]) > 0


def test_trace_order_peak_falls_under_remat(small):
    """The cell's one-card peak is priced in the trace's order, so a
    policy that recomputes lowers it; the emulator's figure stays under
    its own key."""
    r = {p: dryrun.run_cell("granite-8b", "train_4k", "single", remat=p,
                            device="cpu")
         for p in ("none", "full")}
    assert r["full"]["per_device_total_bytes"] < \
        r["none"]["per_device_total_bytes"]
    for rec in r.values():
        assert rec["emulated_peak_bytes"] > 0
        assert rec["fits"] == (rec["per_device_total_bytes"]
                               <= dryrun.H100_HBM_BYTES)


def test_trace_order_peak_by_hand():
    """x (64 floats) held; a = x * 2, v = a viewed, b = v + 1, c = b * 3
    returned with v: a lives while its view does, b dies at c."""
    def f(x):
        a = x * 2
        v = a.view(8, 8)
        b = v + 1
        return b * 3, v

    traced = api.trace(f, torch.zeros(64), record=True)
    n = 64 * 4
    # x, a (kept by the returned view), b and c together
    assert dryrun.trace_order_peak(traced) == 4 * n

    def g(x):
        a = x * 2
        b = a * 3
        c = b * 4
        return c * 5

    traced = api.trace(g, torch.zeros(64), record=True)
    assert dryrun.trace_order_peak(traced) == 3 * n


def test_multi_mesh_and_skips(small):
    r = dryrun.run_cell("granite-8b", "train_4k", "multi", device="cpu")
    assert r["status"] == "SKIP" and "pipeline_apply" in r["reason"]
    r = dryrun.run_cell("hubert-xlarge", "decode_32k", "single",
                        device="cpu")
    assert r["status"] == "SKIP" and "encoder-only" in r["reason"]


def test_cell_asks_for_the_card_by_default(small):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is there")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_cell("granite-8b", "train_4k", "single")


def test_trace_on_fake_tensors_equals_a_real_trace(small):
    """The decode cell's trace (fake tensors from the meta specs) is the
    graph a trace of real CPU tensors of the same shapes gives."""
    cfg, shape = tcfg.get_config("granite-8b"), SMALL["decode_32k"]
    fake = dryrun._trace_cell(cfg, shape, "dots", torch.device("cpu"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    caches = init_cache(cfg, shape.global_batch, shape.seq_len, "cpu")
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
    real = api.trace(build_serve_step(cfg, shape, "cpu"), params, caches,
                     tokens, torch.tensor(3, dtype=torch.int32))
    assert fake.fingerprint == real.fingerprint and fake.n == real.n


def test_serve_step_matches_reference():
    """``build_serve_step`` (the decode cells' step) against the
    reference's on a 1 x 1 mesh: the greedy token, the logits and every
    cache leaf after one step from a prefill."""
    from jax.sharding import AxisType

    from repro.configs.base import ShapeConfig as JShape
    from repro.train.step import build_serve_step as jax_build
    jc = jcfg.reduced(jcfg.get_config("granite-8b"), layers=2)
    tc = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jp = jm.init_params(jc, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 9),
                                               np.int32)
    _, jcache = jm.prefill(jc, jp, {"tokens": jnp.asarray(prompt[:, :8])},
                           32)
    built = jax_build(jc, mesh, JShape("d", 32, 2, "decode"), donate=False)
    jtok, jlogits, jnew = built.fn(jp, jcache, jnp.asarray(prompt[:, 8:]),
                                   jnp.int32(8))
    _, tcache = prefill(tc, tp, {"tokens": torch.from_numpy(prompt[:, :8])},
                        32)
    step = build_serve_step(tc, SMALL["decode_32k"], device="cpu")
    tok, logits, new = step(tp, tcache, prompt[:, 8:],
                            torch.tensor(8, dtype=torch.int32))
    assert tok.dtype == torch.int32 and tok.shape == (2, 1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, jnew))
    mine = tree_flatten(new)[0]
    assert len(mine) == len(got)
    for a, b in zip(mine, got):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="decode shape"):
        build_serve_step(tc, SMALL["train_4k"], device="cpu")


def test_list_prints_every_cell(capsys):
    assert dryrun.main(["--list", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(tcfg.ASSIGNED_ARCHS) * len(dryrun.SHAPES) * 2
    multi = [ln for ln in lines if "__multi" in ln]
    assert multi and all("SKIP" in ln for ln in multi)
    assert sum("pipeline_apply" in ln for ln in lines) == sum(
        "RUN" in ln for ln in lines)        # every single cell that runs
    assert any(ln.rstrip().endswith("RUN") for ln in lines)


def test_cli_cell_writes_its_record(small, tmp_path, capsys):
    assert dryrun.main(["--arch", "granite-8b", "--shape", "train_4k",
                        "--mesh", "single", "--device", "cpu", "--out",
                        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[OK] granite-8b__train_4k__single" in out
    rec = json.loads((tmp_path / "granite-8b__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["remat"] == "full"
    # a second run reads the cell back
    assert dryrun.main(["--arch", "granite-8b", "--shape", "train_4k",
                        "--mesh", "single", "--device", "cpu", "--out",
                        str(tmp_path)]) == 0
    assert "[cached]" in capsys.readouterr().out


def test_pardnn_lint_plan_loads_in_both_packages(tmp_path, capsys):
    """``--pardnn --lint --device cpu`` (0 errors), the plan loaded by
    the port and by the reference, and ``python -m repro_torch.analysis
    PLAN --arch`` clean on it; bound to another arch's trace it reports
    RP033 and exits 1."""
    assert dryrun.main(["--pardnn", "--lint", "--arch", "granite-8b",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[OK] granite-8b" in out and "(0E/" in out
    path = str(tmp_path / "granite-8b__pardnn_k4.plan.json")
    diag = json.loads((tmp_path / "granite-8b__pardnn_k4.diagnostics.json")
                      .read_text())
    assert not [d for d in diag["diagnostics"] if d["severity"] == "error"]
    mine, theirs = api.PartitionPlan.load(path), japi.PartitionPlan.load(path)
    assert mine.fingerprint == theirs.fingerprint
    np.testing.assert_array_equal(mine.assignment, theirs.assignment)
    assert cli_main([path, "--arch", "granite-8b", "--device", "cpu"]) == 0
    rep = str(tmp_path / "rep.json")
    assert cli_main([path, "--arch", "gemma3-1b", "--device", "cpu",
                     "--json", rep]) == 1
    codes = {d["code"] for d in json.loads(open(rep).read())["diagnostics"]}
    assert "RP033" in codes
