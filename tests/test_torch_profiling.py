"""The port's profiling and calibration (``repro_torch.profiling`` and the
API around it) against the JAX reference's ``repro.profiling``, on the
CPU.

Four layers, each with a counterpart of every test in
``tests/test_profiling.py`` and checks that hold the port to the
reference:

* the robust estimator against a *scripted clock* (no real sleeping):
  the same scripts through both packages' ``measure_call`` give equal
  estimates, attempts and samples; ``median_mad``, ``reject_outliers``
  and ``is_bimodal`` agree on seeded arrays;
* the fits: the same seeded samples and device models through both
  packages agree to 1e-12 relative, None where nothing was usable;
* signatures, annotation and ``compare`` on identical cost graphs built
  in both packages; the ``CalibrationProfile`` artifact, which crosses
  between the packages both ways bit for bit;
* the closed loop on the reduced repro-lm-100m training step: calibrate
  (quick spec) -> annotate -> partition K=2 -> accuracy_report, the
  replay and the calibrated plan equal to the eager step within 2e-5.
"""
import json
import os
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro.api as japi  # noqa: E402
import repro.profiling as jprof  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.profiling import measure as jmeasure  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.profiling as tprof  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.conformance import make_train_step  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import errors as terr  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.profiling import measure as tmeasure  # noqa: E402
from repro_torch.profiling import opbench as topbench  # noqa: E402
from repro_torch.profiling import (CalibrationProfile, MeasureSpec,  # noqa: E402
                                   OpSample, ProfileValidationError,
                                   TransferSample, fit_alpha_beta,
                                   fit_compute_params, measure_call,
                                   median_mad, quick_spec)
from repro_torch.profiling.measure import (is_bimodal,  # noqa: E402
                                           reject_outliers)
from repro_torch.tree import tree_flatten  # noqa: E402

REL = 1e-12           # port against reference, the fits and annotation
LOOP_TOL = dict(atol=2e-5, rtol=2e-5)   # replays against the eager step


# ---------------------------------------------------------------- clock
class ScriptClock:
    """Deterministic clock: the i-th timed sample observes ``deltas[i]``
    seconds (the clock is read twice per sample: start and end); the
    last delta repeats."""

    def __init__(self, deltas):
        self.deltas = list(deltas)
        self.i = 0
        self.t = 0.0
        self._in_sample = False

    def __call__(self) -> float:
        if not self._in_sample:
            self._in_sample = True
            return self.t
        d = self.deltas[min(self.i, len(self.deltas) - 1)]
        self.i += 1
        self.t += d
        self._in_sample = False
        return self.t


def _measure(deltas, spec, pkg=tmeasure):
    clock = ScriptClock(deltas)
    return pkg.measure_call(lambda: None, spec=spec, clock=clock), clock


# the reference's scripts: (deltas, MeasureSpec fields)
SCRIPTS = {
    "clean": ([1e-4, 1.01e-4, 0.99e-4, 1.0e-4, 1.02e-4],
              dict(warmup=0, reps=5, max_attempts=3)),
    "outlier": ([1e-4, 1.0e-4, 1.01e-4, 0.99e-4, 5e-2],
                dict(warmup=0, reps=5, max_attempts=1)),
    "bimodal_then_quiet": (
        [1e-4, 1.01e-4, 1.02e-4, 3.0e-4, 3.01e-4, 3.02e-4]
        + [1e-4, 1.0e-4, 1.01e-4, 0.99e-4, 1.0e-4, 1.02e-4,
           0.98e-4, 1.0e-4, 1.01e-4, 1.0e-4, 1.0e-4, 1.01e-4],
        dict(warmup=0, reps=6, max_attempts=3, dispersion_target=0.05)),
    "persistently_noisy": ([1e-4, 4e-4] * 40,
                           dict(warmup=0, reps=4, max_attempts=3,
                                dispersion_target=0.05)),
    "long_call": ([2.5], dict(warmup=0, reps=5, reps_long=1,
                              long_call_s=1.0)),
    "warmup": ([9.0, 9.0, 1e-4, 1.0e-4, 1.01e-4],
               dict(warmup=2, reps=3, max_attempts=1)),
}


# ------------------------------------------------------------ estimator
def test_median_mad_basic():
    med, mad = median_mad([1.0, 2.0, 3.0, 4.0, 100.0])
    assert med == 3.0 and mad == 1.0


def test_reject_outliers_drops_wild_sample():
    s = np.array([1.0, 1.01, 0.99, 1.02, 50.0])
    kept = reject_outliers(s, 3.5)
    assert 50.0 not in kept and kept.size == 4


def test_reject_outliers_degenerate_mad():
    s = np.array([1.0, 1.0, 1.0, 1.0, 9.0])
    assert 9.0 not in reject_outliers(s, 3.5)


def test_bimodal_detection():
    lo, hi = [1e-4, 1.02e-4, 0.99e-4], [5e-4, 5.05e-4, 4.95e-4]
    assert is_bimodal(np.array(lo + hi), 4.0)
    assert not is_bimodal(np.array([1e-4, 1.01e-4, 0.99e-4, 1.02e-4]), 4.0)


def test_clean_window_accepts_first_attempt():
    deltas, kw = SCRIPTS["clean"]
    m, _ = _measure(deltas, MeasureSpec(**kw))
    assert m.attempts == 1 and not m.noisy and not m.bimodal
    assert m.seconds == pytest.approx(1e-4, rel=0.05)


def test_outlier_does_not_skew_estimate():
    deltas, kw = SCRIPTS["outlier"]
    m, _ = _measure(deltas, MeasureSpec(**kw))
    assert m.seconds == pytest.approx(1e-4, rel=0.05)
    assert m.kept.size < m.samples.size


def test_bimodal_window_triggers_retry_and_quiet_window_wins():
    deltas, kw = SCRIPTS["bimodal_then_quiet"]
    m, _ = _measure(deltas, MeasureSpec(**kw))
    assert m.attempts == 2 and not m.noisy
    assert m.seconds == pytest.approx(1e-4, rel=0.05)


def test_persistently_noisy_flagged_and_best_attempt_kept():
    deltas, kw = SCRIPTS["persistently_noisy"]
    m, _ = _measure(deltas, MeasureSpec(**kw))
    assert m.attempts == 3 and m.noisy


def test_long_call_single_sample_regime():
    deltas, kw = SCRIPTS["long_call"]
    m, clock = _measure(deltas, MeasureSpec(**kw))
    assert m.seconds == pytest.approx(2.5)
    assert m.samples.size == 1 and clock.i == 1


def test_warmup_samples_not_recorded():
    deltas, kw = SCRIPTS["warmup"]
    m, _ = _measure(deltas, MeasureSpec(**kw))
    assert m.seconds == pytest.approx(1e-4, rel=0.05)


def test_measure_call_returns_fn_result():
    m = measure_call(lambda: 42, spec=quick_spec(reps=2, max_attempts=1))
    assert m.result == 42
    assert m.to_dict()["kept"] >= 1


def test_measurement_dict_keys():
    """The port's counterpart of the reference's benchmark-helper test:
    the evidence every timed number carries."""
    m = measure_call(lambda: "ok", spec=quick_spec(reps=2, max_attempts=1))
    d = m.to_dict()
    assert {"seconds", "mad", "dispersion", "samples", "kept", "attempts",
            "noisy", "bimodal"} == set(d)
    assert m.us == pytest.approx(m.seconds * 1e6) and m.seconds >= 0


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_measure_call_matches_reference(script):
    deltas, kw = SCRIPTS[script]
    t, _ = _measure(deltas, tmeasure.MeasureSpec(**kw), tmeasure)
    j, _ = _measure(deltas, jmeasure.MeasureSpec(**kw), jmeasure)
    assert (t.seconds, t.dispersion, t.attempts, t.noisy, t.bimodal) == \
        (j.seconds, j.dispersion, j.attempts, j.noisy, j.bimodal)
    np.testing.assert_array_equal(t.samples, j.samples)
    np.testing.assert_array_equal(t.kept, j.kept)
    assert t.to_dict() == j.to_dict()


@pytest.mark.parametrize("seed", range(8))
def test_estimator_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    s = rng.lognormal(-9, 0.3, n)
    if seed % 2:                      # a second mode, or a wild sample
        s[: n // 2] *= 4.0 if seed % 4 == 1 else 1.0
        s[-1] *= 50.0
    if seed == 6:
        s[:] = 1e-4                   # degenerate MAD
        s[0] = 9e-4
    assert median_mad(s) == jmeasure.median_mad(s)
    for mads in (2.0, 3.5):
        np.testing.assert_array_equal(reject_outliers(s, mads),
                                      jmeasure.reject_outliers(s, mads))
    for gap in (2.0, 4.0):
        assert is_bimodal(s, gap) == jmeasure.is_bimodal(s, gap)


def test_synchronize_passes_cpu_values_through():
    x = torch.ones(3)
    assert tmeasure.synchronize(x) is x
    assert tmeasure.synchronize((x, [x], None))[0] is x


# ----------------------------------------------------------------- fits
def test_fit_alpha_beta_recovers_parameters():
    sizes = np.array([1e3, 1e4, 1e5, 1e6, 1e7])
    alpha_true, bw_true = 2e-5, 5e9
    alpha, bw = fit_alpha_beta(sizes, alpha_true + sizes / bw_true)
    assert alpha == pytest.approx(alpha_true, rel=1e-6)
    assert bw == pytest.approx(bw_true, rel=1e-6)


def test_fit_alpha_beta_noise_fallback_positive():
    alpha, bw = fit_alpha_beta([1e3, 1e6], [5e-4, 1e-4])
    assert alpha >= 0 and bw > 0


def test_fit_compute_params_splits_at_ridge():
    h100 = tcost.H100
    eff_true, bw_true = 0.25, 2e11
    compute = OpSample(signature="mm", name="mm", flops=1e15,
                       bytes_touched=1e6, out_bytes=1e6,
                       seconds=1e15 / (h100.peak_flops * eff_true),
                       dispersion=0.01)
    memory = OpSample(signature="add", name="add", flops=1e3,
                      bytes_touched=1e9, out_bytes=1e9,
                      seconds=1e9 / bw_true, dispersion=0.01)
    eff, bw = fit_compute_params([compute, memory], h100)
    assert eff == pytest.approx(eff_true, rel=1e-3)
    assert bw == pytest.approx(bw_true, rel=1e-3)


def test_fit_params_preserves_unfitted_none():
    fitted = tprof.fit_params([], [], tcost.H100)
    assert set(fitted) == {"flop_efficiency", "hbm_bw", "link_bw",
                           "link_latency"}
    assert all(v is None for v in fitted.values())


def test_scan_slice_signatures_collapse():
    sig = tprof.node_signature
    assert sig("scan_slice_3", 0.0, 8.0, 8.0) == \
        sig("scan_slice_11", 0.0, 8.0, 8.0)
    assert sig("scan_stack", 0.0, 8.0, 8.0) != \
        sig("scan_slice", 0.0, 8.0, 8.0)


def test_fit_compute_params_excludes_noisy_samples():
    noisy = OpSample(signature="x", name="x", flops=1e12,
                     bytes_touched=1e6, out_bytes=0, seconds=1.0,
                     dispersion=0.9)
    assert fit_compute_params([noisy], tcost.H100) == (None, None)


def _sample_numbers(seed: int):
    """Seeded op and transfer measurements as plain numbers, so that both
    packages build their samples from the same values. Seed 0: nothing
    usable (every sample noisy or too fast)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(int(rng.integers(3, 30))):
        fl = 0.0 if rng.random() < 0.2 else float(10 ** rng.uniform(3, 14))
        ops.append(dict(signature=f"op{i}|s", name=f"op{i}", flops=fl,
                        bytes_touched=float(10 ** rng.uniform(2, 10)),
                        out_bytes=float(10 ** rng.uniform(2, 8)),
                        seconds=float(10 ** rng.uniform(-7, -2)),
                        dispersion=float(rng.uniform(0, 0.8)),
                        count=int(rng.integers(1, 6))))
    trs = [dict(nbytes=float(1 << (10 + 2 * i)),
                seconds=float(rng.uniform(1e-6, 1e-5)
                              + (1 << (10 + 2 * i)) / 1e12
                              * rng.uniform(0.8, 1.2)),
                dispersion=float(rng.uniform(0, 0.7)))
           for i in range(int(rng.integers(1, 7)))]
    if seed == 0:
        for o in ops:
            o["dispersion"] = 0.9
        for t in trs:
            t["dispersion"] = 0.9
    return ops, trs, float(rng.uniform(0, 2e-5))


def _assert_rel(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        assert a == pytest.approx(b, rel=REL, abs=0)


@pytest.mark.parametrize("base", ["h100", "v100"])
@pytest.mark.parametrize("seed", range(6))
def test_fits_match_reference(seed, base):
    ops, trs, overhead = _sample_numbers(seed)
    fields = (tcost.H100 if base == "h100" else tcost.V100).to_dict()
    tdm, jdm = tcost.DeviceModel(**fields), jcost.DeviceModel(**fields)
    tops = [OpSample(**o) for o in ops]
    jops = [jprof.OpSample(**o) for o in ops]
    ttrs = [TransferSample(**t) for t in trs]
    jtrs = [jprof.TransferSample(**t) for t in trs]
    sizes, secs = [t["nbytes"] for t in trs], [t["seconds"] for t in trs]
    for a, b in zip(fit_alpha_beta(sizes, secs),
                    jprof.fit_alpha_beta(sizes, secs)):
        _assert_rel(a, b)
    for a, b in zip(fit_compute_params(tops, tdm, overhead),
                    jprof.fit_compute_params(jops, jdm, overhead)):
        _assert_rel(a, b)
    tf = tprof.fit_params(tops, ttrs, tdm, dispatch_overhead_s=overhead)
    jf = jprof.fit_params(jops, jtrs, jdm, dispatch_overhead_s=overhead)
    assert set(tf) == set(jf)
    for key in tf:
        _assert_rel(tf[key], jf[key])
    if seed == 0:
        assert all(v is None for v in tf.values())
    tm = tprof.fit_device_model(tops, ttrs, tdm,
                                dispatch_overhead_s=overhead)
    jm = jprof.fit_device_model(jops, jtrs, jdm,
                                dispatch_overhead_s=overhead)
    assert set(tm.to_dict()) == set(jm.to_dict())
    for key, v in tm.to_dict().items():
        if isinstance(v, str):
            assert v == jm.to_dict()[key]
        else:
            _assert_rel(v, jm.to_dict()[key])


# ------------------------------------------- signatures and annotation
def _graph_pair(seed: int):
    """The same annotated random DAG built by each package, with op
    names, FLOPs and bytes from a seed."""
    rng = np.random.default_rng(100 + seed)
    kw = dict(n=int(rng.integers(30, 120)), avg_deg=2.0, seed=seed,
              frac_residual=0.1)
    jg, tg = jgraph.random_dag(**kw), tgraph.random_dag(**kw)
    names = [f"op{int(i)}" for i in rng.integers(0, 6, kw["n"])]
    flops = np.where(rng.random(kw["n"]) < 0.3, 0.0,
                     np.round(10 ** rng.uniform(3, 12, kw["n"])))
    nbytes = np.round(10 ** rng.uniform(2, 9, kw["n"]))
    for g in (jg, tg):
        g.names = list(names)
        g.op_flops = flops.copy()
        g.op_bytes = nbytes.copy()
    assert jg.fingerprint() == tg.fingerprint()
    return jg, tg


@pytest.mark.parametrize("seed", range(3))
def test_graph_signatures_match_reference(seed):
    jg, tg = _graph_pair(seed)
    assert tprof.graph_signatures(tg) == jprof.graph_signatures(jg)


def test_graph_signatures_need_annotations():
    g = tgraph.random_dag(10, seed=0)
    with pytest.raises(ValueError, match="op_flops"):
        tprof.graph_signatures(g)


def _profile_fields(sigs: list[str], seed: int, fingerprint: str) -> dict:
    """A profile measuring every other signature of a graph, with fitted
    values on every side but the link latency, as plain values."""
    rng = np.random.default_rng(seed)
    ops = [dict(signature=s, name=s.split("|")[0], flops=1.0,
                bytes_touched=2.0, out_bytes=3.0,
                seconds=float(10 ** rng.uniform(-6, -3)),
                dispersion=0.01, count=1,
                samples=rng.random(int(rng.integers(1, 5))))
           for s in sorted(set(sigs))[::2]]
    trs = [dict(nbytes=float(1 << (10 + 3 * i)),
                seconds=1e-5 + (1 << (10 + 3 * i)) / 1e9, dispersion=0.02,
                samples=rng.random(3)) for i in range(3)]
    return dict(ops=ops, transfers=trs,
                fitted={"flop_efficiency": 0.37, "hbm_bw": 2.1e12,
                        "link_bw": 1.3e12, "link_latency": None},
                base_model=tcost.H100.to_dict(),
                device_fingerprint=fingerprint,
                dispatch_overhead_s=4e-6, fusion_factor=0.61,
                meta={"origin": "synthetic"})


def _build_profile(pkg, fields: dict):
    return pkg.CalibrationProfile(
        ops=[pkg.OpSample(**o) for o in fields["ops"]],
        transfers=[pkg.TransferSample(**t) for t in fields["transfers"]],
        **{k: v for k, v in fields.items() if k not in ("ops", "transfers")})


def _edge_costs(g) -> list:
    return [c for edges in g.out_edges for _, c in edges] + \
        [c for edges in g.in_edges for _, c in edges]


@pytest.mark.parametrize("seed", range(3))
def test_annotate_and_compare_match_reference(seed):
    jg, tg = _graph_pair(seed)
    fields = tcost.H100.to_dict()
    jt = japi.TracedModel(graph=jg, program=None, fingerprint=jg.fingerprint(),
                          device_model=jcost.DeviceModel(**fields))
    tt = tapi.TracedModel(graph=tg, program=None, fingerprint=tg.fingerprint(),
                          device_model=tcost.DeviceModel(**fields))
    before = tt.fingerprint
    comp_before = np.array(tg.comp, dtype=np.float64)
    prof = _profile_fields(tprof.graph_signatures(tg), seed, "any")
    jt.annotate(_build_profile(jprof, prof))
    tt.annotate(_build_profile(tprof, prof))
    jc, tc = np.asarray(jg.comp), np.asarray(tg.comp)
    np.testing.assert_allclose(tc, jc, rtol=REL, atol=0)
    assert not np.allclose(tc, comp_before)
    np.testing.assert_allclose(_edge_costs(tg), _edge_costs(jg), rtol=REL,
                               atol=0)
    assert tt.fingerprint != before and tt.fingerprint == tg.fingerprint()
    assert tt.device_model.name.endswith("+calibrated")
    assert tt.device_model.flop_efficiency == 0.37
    # the baselines on the re-priced graph: equal makespans
    jp, tp = japi.partition(jt, devices=3), tapi.partition(tt, devices=3)
    assert jp.makespan == tp.makespan
    jcmp, tcmp = jp.compare(), tp.compare()
    assert set(tcmp) == set(jcmp) == {"rr", "topo"}
    for name in tcmp:
        assert tcmp[name] == jcmp[name]


def test_compare_rejects_unknown_baseline():
    _, tg = _graph_pair(0)
    plan = tapi.partition(tg, devices=2)
    with pytest.raises(ValueError, match="unknown baseline"):
        plan.compare(["nope"])


# ------------------------------------------------------------- artifact
def _synthetic(pkg=tprof, fingerprint="test|fake|x2|torch=0.0"):
    fields = _profile_fields([f"op{i}|f=1|b=2|o=3" for i in range(8)], 0,
                             fingerprint)
    fields["fitted"]["link_latency"] = 1.5e-5
    return _build_profile(pkg, fields)


def _assert_profiles_equal(p, q):
    assert tprof.profile_differences(p, q) == []


@pytest.mark.parametrize("change", ["meta", "fusion_factor", "op_sample",
                                    "transfer_sample", "ops_length",
                                    "transfer_nbytes"])
def test_profile_differences_names_what_differs(change):
    p, q = _synthetic(), _synthetic()
    assert tprof.profile_differences(p, q) == []
    if change == "meta":
        q.meta["extra"] = 1
        want = "profile.meta"
    elif change == "fusion_factor":
        q.fusion_factor = np.nextafter(q.fusion_factor, 2.0)
        want = "profile.fusion_factor"
    elif change == "op_sample":
        q.ops[3].samples = q.ops[3].samples.copy()
        q.ops[3].samples[-1] = np.nextafter(q.ops[3].samples[-1], 1.0)
        want = "profile.ops[3].samples"
    elif change == "transfer_sample":
        q.transfers[1].samples = q.transfers[1].samples[:-1]
        want = "profile.transfers[1].samples"
    elif change == "ops_length":
        q.ops.pop()
        want = f"profile.ops (length {len(p.ops)} against {len(q.ops)})"
    else:
        q.transfers[0].nbytes *= 2
        want = "profile.transfers[0].nbytes"
    assert tprof.profile_differences(p, q) == [want]


def test_profile_roundtrip_bit_for_bit(tmp_path):
    p = _synthetic()
    path = str(tmp_path / "prof.json")
    p.save(path)
    q = CalibrationProfile.load(path)
    _assert_profiles_equal(p, q)
    m = q.device_model()
    assert m.flop_efficiency == 0.37 and m.link_bw == 1.3e12
    assert m.name.endswith("+calibrated")


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_profile_crosses_packages(tmp_path, direction):
    src, dst = (tprof, jprof) if direction == "port_to_reference" \
        else (jprof, tprof)
    p = _synthetic(src)
    path = str(tmp_path / "prof.json")
    p.save(path)
    q = dst.CalibrationProfile.load(path)
    _assert_profiles_equal(p, q)
    assert q.device_model().to_dict() == p.device_model().to_dict()
    assert q.op_seconds_by_signature() == p.op_seconds_by_signature()


def test_profile_rejects_corrupted_payload(tmp_path):
    path = str(tmp_path / "prof.json")
    _synthetic().save(path)
    with open(str(tmp_path / "prof.npz"), "ab") as f:
        f.write(b"\0")
    with pytest.raises(ProfileValidationError, match="corrupt") as e:
        CalibrationProfile.load(path)
    assert e.value.code == terr.RP103_PAYLOAD_CORRUPT


def test_profile_rejects_unknown_schema_version(tmp_path):
    path = str(tmp_path / "prof.json")
    _synthetic().save(path)
    with open(path) as f:
        header = json.load(f)
    header["schema_version"] = 999
    with open(path, "w") as f:
        json.dump(header, f)
    with pytest.raises(ProfileValidationError, match="schema version") as e:
        CalibrationProfile.load(path)
    assert e.value.code == terr.RP101_SCHEMA_UNKNOWN


def test_profile_rejects_wrong_format(tmp_path):
    path = str(tmp_path / "notaprofile.json")
    with open(path, "w") as f:
        json.dump({"format": "something-else"}, f)
    with pytest.raises(ProfileValidationError, match="not a") as e:
        CalibrationProfile.load(path)
    assert e.value.code == terr.RP105_PROFILE_INVALID


def test_profile_device_fingerprint_enforcement(tmp_path):
    path = str(tmp_path / "prof.json")
    _synthetic().save(path)
    CalibrationProfile.load(path, expect_device="test|fake|x2|torch=0.0")
    with pytest.raises(ProfileValidationError, match="measured on") as e:
        CalibrationProfile.load(path, expect_device="other|real|x8|torch=9")
    assert e.value.code == terr.RP104_DEVICE_MISMATCH
    with pytest.raises(ProfileValidationError, match="measured on"):
        CalibrationProfile.load(path, expect_device=True)
    # a profile measured here passes the check
    _synthetic(fingerprint=tprof.current_device_fingerprint()).save(path)
    CalibrationProfile.load(path, expect_device=True)


def test_profile_validation_error_is_plan_validation_error():
    assert issubclass(ProfileValidationError, tapi.PlanValidationError)
    assert ProfileValidationError("x").code == terr.RP105_PROFILE_INVALID


def test_current_device_fingerprint():
    fp = tprof.current_device_fingerprint()
    if torch.cuda.is_available():
        want = (f"cuda|{torch.cuda.get_device_name()}|"
                f"x{torch.cuda.device_count()}|torch={torch.__version__}")
    else:
        want = f"cpu|cpu|x1|torch={torch.__version__}"
    assert fp == want


def test_transfer_probe_names_the_copy():
    src, dst = topbench.transfer_pair("cpu")
    assert src == dst == torch.device("cpu")
    assert topbench.transfer_probe(src, dst) == "host copy on cpu"
    assert topbench.transfer_probe("cuda:0", "cuda:0") == \
        "device-to-device copy on cuda:0"
    assert topbench.transfer_probe("cuda:0", "cuda:1") == \
        "peer copy cuda:0 -> cuda:1"
    # the reference's ladder on the CPU; on a card one that reaches past
    # what it copies in a host-timed call's overhead
    assert tprof.default_transfer_sizes("cpu") == \
        tprof.DEFAULT_TRANSFER_SIZES == jprof.DEFAULT_TRANSFER_SIZES
    assert tprof.default_transfer_sizes("cuda:0") == \
        tprof.CUDA_TRANSFER_SIZES
    assert tprof.CUDA_TRANSFER_SIZES[0] == 4 << 10
    assert tprof.CUDA_TRANSFER_SIZES[-1] == 256 << 20
    samples = tprof.profile_transfers((1 << 12, 1 << 16), src="cpu",
                                      spec=quick_spec(reps=2,
                                                      max_attempts=1))
    assert [s.nbytes for s in samples] == [4096.0, 65536.0]
    assert all(s.seconds > 0 and s.samples.size >= 2 for s in samples)


def _tiny(x, w):
    return torch.tanh(x @ w).sum(-1)


def _tiny_trace(**kw):
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    w = torch.randn(16, 16, generator=torch.Generator().manual_seed(1))
    return tapi.trace(_tiny, x, w, record=True, **kw), (x, w)


def test_trace_calibration_reprices(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_CALIBRATION", raising=False)
    plain, _ = _tiny_trace()
    path = str(tmp_path / "prof.json")
    _synthetic(fingerprint=tprof.current_device_fingerprint()).save(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # a match does not warn
        by_path, _ = _tiny_trace(calibration=path)
    assert by_path.device_model.name.endswith("+calibrated")
    assert by_path.device_model.flop_efficiency == 0.37
    assert by_path.fingerprint != plain.fingerprint
    assert not np.array_equal(by_path.graph.comp, plain.graph.comp)
    monkeypatch.setenv("REPRO_CALIBRATION", path)
    by_env, _ = _tiny_trace()
    assert by_env.fingerprint == by_path.fingerprint
    np.testing.assert_array_equal(by_env.graph.comp, by_path.graph.comp)
    _synthetic().save(path)                      # another device's profile
    with pytest.warns(UserWarning, match="measured on"):
        mismatched, _ = _tiny_trace()
    assert mismatched.fingerprint == by_path.fingerprint


# --------------------------------------------------- runtime and replay
def test_time_node_runs_a_writing_op_once_on_the_real_inputs():
    add_ = torch.ops.aten.add_.Tensor
    assert topbench._writes_input(add_)
    assert not topbench._writes_input(torch.ops.aten.add.Tensor)
    x0 = torch.arange(6.0)
    y = torch.full((6,), 0.5)
    for op, writes in ((add_, True), (torch.ops.aten.add.Tensor, False)):
        x = x0.clone()
        spec = torch.utils._pytree.tree_flatten((x, y))[1]
        prog = types.SimpleNamespace(program={3: (op, {}, [])},
                                     arg_specs={3: spec})
        m = topbench._time_node(prog, 3, [x, y], {},
                                quick_spec(reps=4, max_attempts=2))
        assert m.samples.size >= 4
        torch.testing.assert_close(m.result, x0 + y, rtol=0, atol=0)
        torch.testing.assert_close(x, x0 + y if writes else x0, rtol=0,
                                   atol=0)


def test_run_calibration_refuses_fake_and_meta_inputs():
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 16, device="meta")
    traced = tapi.trace(_tiny, x, w, record=True)
    with pytest.raises(ValueError, match="concrete"):
        tapi.calibrate(traced, device="cpu")
    with pytest.raises(ValueError, match="record=True"):
        tapi.calibrate(tapi.trace(_tiny, torch.ones(8, 16),
                                  torch.ones(16, 16)), device="cpu")


def test_run_calibration_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    traced, _ = _tiny_trace()
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.calibrate(traced)


def test_runtime_segment_profiling_mode():
    traced, args = _tiny_trace()
    plan = tapi.partition(traced, devices=2)
    rt_out = plan.execute(*args, devices=["cpu"], device_map=[0, 0])
    rt = plan._compiled_runtime[1]
    assert rt.stats.segment_seconds == []
    prof = tprof.profile_segments(rt, *args, reps=3, warmup=False)
    assert prof["samples"].shape == (3, rt.stats.num_segments)
    assert np.all(prof["seconds"] > 0) and prof["wall_seconds"].size == 3
    assert rt.stats.mode == "sync" and rt.mode == "async"
    again = plan.execute(*args, devices=["cpu"], device_map=[0, 0])
    assert rt.stats.segment_seconds == [] and not rt.profile_segments
    torch.testing.assert_close(again, rt_out, rtol=0, atol=0)


# ------------------------------------------------------- the closed loop
def _reference_accuracy_keys() -> tuple[set, set]:
    """The keys of the reference's scorecard and of one stage's entry,
    from a tiny JAX program on the CPU."""
    def f(x, w):
        return jnp.tanh(x @ w).sum(-1)
    x = jnp.ones((8, 16), jnp.float32)
    w = jnp.ones((16, 16), jnp.float32) * 0.1
    traced = repro.trace(f, x, w, record=True)
    plan = repro.partition(traced, devices=2)
    acc = plan.accuracy_report(x, w, device_map=[0, 0], reps=1)
    return set(acc), set(acc["per_stage"][0])


@pytest.fixture(scope="module")
def lm_loop(tmp_path_factory):
    """calibrate -> annotate -> partition -> accuracy_report on the
    reduced repro-lm-100m training step (CPU, quick spec)."""
    cfg = tcfg.reduced(tcfg.get_config("repro-lm-100m"), layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16),
                                              np.int32))
             for k in ("tokens", "targets")}
    step = make_train_step(cfg)
    traced = tapi.trace(step, params, batch, record=True, autograd=True)
    comp_before = np.array(traced.graph.comp, dtype=float, copy=True)
    fp_before = traced.fingerprint
    plan_before = tapi.partition(traced, devices=2)
    spec = quick_spec(reps=2, max_attempts=1)
    flat = tree_flatten((params, batch))[0]
    kept = [t.clone() for t in flat]
    path = str(tmp_path_factory.mktemp("calib") / "prof.json")
    profile = tapi.calibrate(traced, device="cpu", spec=spec,
                             max_signatures=25,
                             sizes=(1 << 12, 1 << 16, 1 << 20),
                             meta={"test": True}, save=path)
    _, replayed = topbench._replay(traced.graph, traced.program, flat,
                                   torch.device("cpu"), spec, None)
    unchanged = all(torch.equal(a, b) for a, b in zip(flat, kept))
    traced.annotate(profile)
    plan = tapi.partition(traced, devices=2, meta={"test": True})
    acc = plan.accuracy_report(params, batch, devices=["cpu"],
                               device_map=[0, 0], reps=2)
    return dict(traced=traced, profile=profile, plan=plan, acc=acc,
                comp_before=comp_before, fp_before=fp_before,
                plan_before=plan_before, params=params, batch=batch,
                step=step, replayed=replayed, unchanged=unchanged,
                path=path)


def test_loop_profile_measures_real_ops(lm_loop):
    profile = lm_loop["profile"]
    assert 0 < len(profile.ops) <= 25
    assert all(s.seconds > 0 for s in profile.ops)
    assert len(profile.transfers) == 3
    assert profile.dispatch_overhead_s > 0
    assert 0 < profile.fusion_factor <= 2.0
    assert set(profile.fitted) == {"flop_efficiency", "hbm_bw",
                                   "link_bw", "link_latency"}
    assert all(v is None or v >= 0 for v in profile.fitted.values())
    meta = profile.meta
    assert meta["test"] is True and meta["transfer_probe"] == \
        "host copy on cpu" and meta["device"] == "cpu"
    assert meta["signatures_measured"] == len(profile.ops) <= \
        meta["signatures"] and meta["seconds"] > 0
    assert profile.device_fingerprint == tprof.current_device_fingerprint()
    # views (no FLOPs, no bytes: no kernel) are replayed, not timed
    g = lm_loop["traced"].graph
    views = [i for i in lm_loop["traced"].program.program
             if g.op_flops[i] == 0 and g.op_bytes[i] == 0]
    assert views and all(s.flops > 0 or s.bytes_touched > 0
                         for s in profile.ops)
    # the artifact saved by the call loads back bit for bit, and in the
    # reference's loader too
    _assert_profiles_equal(profile, CalibrationProfile.load(lm_loop["path"]))
    _assert_profiles_equal(profile,
                           jprof.CalibrationProfile.load(lm_loop["path"]))


def test_loop_replay_matches_eager(lm_loop):
    """profile_ops' replay (every node run once on the real values, the
    timed ones also in the timing loop) gives the eager step's outputs
    and leaves the inputs as they were."""
    assert lm_loop["unchanged"]
    want = lm_loop["step"](lm_loop["params"], lm_loop["batch"])
    got = tree_flatten(lm_loop["replayed"])[0]
    want = tree_flatten(want)[0]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **LOOP_TOL)


def test_loop_annotation_changes_costs_and_fingerprint(lm_loop):
    traced = lm_loop["traced"]
    comp_after = np.asarray(traced.graph.comp, dtype=float)
    assert comp_after.shape == lm_loop["comp_before"].shape
    assert not np.allclose(comp_after, lm_loop["comp_before"])
    assert traced.fingerprint != lm_loop["fp_before"]
    assert traced.device_model.name.endswith("+calibrated")
    # a plan made on the old prices no longer binds
    with pytest.raises(tapi.PlanValidationError) as e:
        lm_loop["plan_before"].bind(traced)
    assert e.value.code == terr.RP102_FINGERPRINT_MISMATCH


def test_loop_accuracy_report_scorecard(lm_loop):
    acc = lm_loop["acc"]
    keys, stage_keys = _reference_accuracy_keys()
    assert set(acc) == keys and set(acc["per_stage"][0]) == stage_keys
    plan = lm_loop["plan"]
    rt = plan._compiled_runtime[1]
    assert acc["num_stages"] == rt.stats.num_segments >= 1
    assert len(acc["per_stage"]) == acc["num_stages"]
    assert acc["stages_scored"] >= 1
    assert np.isfinite(acc["stage_mape_pct"])
    assert acc["measured_wall_s"] > 0 and acc["predicted_makespan_s"] > 0
    for st in acc["per_stage"]:
        assert st["measured_s"] >= 0 and st["predicted_s"] >= 0
    assert acc["timing_modes"]["per_stage"] == "sync"
    assert acc["timeline"]["mode"] == "async"
    # the scorecard rides on the plan's report and serializes
    assert plan.report.accuracy["stage_mape_pct"] == acc["stage_mape_pct"]
    json.loads(json.dumps(plan.report.to_dict()))
    json.loads(json.dumps(acc))


def test_loop_calibrated_plan_executes(lm_loop):
    plan, params, batch = lm_loop["plan"], lm_loop["params"], \
        lm_loop["batch"]
    kw = dict(devices=["cpu"], device_map=[0, 0])
    out = plan.execute(params, batch, runtime="compiled", **kw)
    ref = plan.execute(params, batch, runtime="interpret", **kw)
    want = lm_loop["step"](params, batch)
    for a, b, c in zip(tree_flatten(out)[0], tree_flatten(ref)[0],
                       tree_flatten(want)[0]):
        torch.testing.assert_close(a, b, **LOOP_TOL)
        torch.testing.assert_close(a, c, **LOOP_TOL)


def test_loop_benchmark_runtimes(lm_loop):
    plan, params, batch = lm_loop["plan"], lm_loop["params"], \
        lm_loop["batch"]
    res = plan.benchmark_runtimes(params, batch, devices=["cpu"],
                                  device_map=[0, 0], reps=2)
    assert res["interpreter_s"] > 0 and res["compiled_s"] > 0
    assert res["output_drift"] <= 2e-5 and res["sync_async_drift"] == 0.0
    assert res["num_segments"] == plan._compiled_runtime[1].stats \
        .num_segments
    assert set(res["timing_modes"]) == {"async", "sync"}
    assert "timing_modes" in plan.report.runtime
    json.loads(json.dumps(res))
