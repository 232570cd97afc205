"""The port's static plan verifier against the JAX reference's: the same
diagnostics (code, severity, pass, node, segment, device) on random
synthetic programs and on the port's reduced granite-8b decode plan;
every mutation class of the reference's harness, applied to the port's
schedule, caught by the port's analyzer; the port's own generator and
harness (``repro_torch.analysis.synth`` / ``mutate``) giving the
reference's programs, cases and codes for the same seeds; the command
line's exit codes; and the facade refusing a corrupt plan at save and at
execute (RP107)."""
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro import analysis as janalysis  # noqa: E402
from repro.analysis import mutate as jmutate  # noqa: E402
from repro.analysis import synth as jsynth  # noqa: E402
from repro.analysis.mutate import (MUTATIONS, MutableCase,  # noqa: E402
                                   apply_mutation)
from repro.analysis.synth import (random_assignment,  # noqa: E402
                                  random_program)
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch import analysis as tanalysis  # noqa: E402
from repro_torch.analysis import mutate as tmutate  # noqa: E402
from repro_torch.analysis import synth as tsynth  # noqa: E402
from repro_torch.analysis.__main__ import main as cli_main  # noqa: E402
from repro_torch.core.executor import TracedProgram  # noqa: E402
from repro_torch.analysis.passes import (AnalysisContext,  # noqa: E402
                                         abstract_interpret)
from repro_torch.core import errors as terr  # noqa: E402
from repro_torch.core.segments import cut_segments  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import partition_for_serving  # noqa: E402


def _findings(rep):
    return [(d.code, d.severity, d.pass_name, d.node, d.segment, d.device)
            for d in rep.diagnostics]


def _assert_same_report(ref, port):
    assert _findings(port) == _findings(ref)
    assert port.passes_run == ref.passes_run
    assert port.skipped == ref.skipped


@pytest.fixture(scope="module")
def decode_plan():
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return partition_for_serving(cfg, params, devices=4, device="cpu")


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("seed", range(5))
def test_analyze_matches_reference_on_synth(seed, k):
    rng = np.random.default_rng(100 + seed)
    prog = random_program(rng, n_ops=int(rng.integers(10, 30)), p_multi=0.3)
    a = random_assignment(rng, prog, k)
    _assert_same_report(janalysis.analyze(prog, a, k),
                        tanalysis.analyze(prog, a, k))
    assert not tanalysis.analyze(prog, a, k).has_errors()


def test_analyze_matches_reference_on_corrupt_placement():
    rng = np.random.default_rng(5)
    prog = random_program(rng, n_ops=20)
    a = random_assignment(rng, prog, 3)
    a[max(prog.program)] = 7                     # outside [0, 3)
    ref, port = janalysis.analyze(prog, a, 3), tanalysis.analyze(prog, a, 3)
    _assert_same_report(ref, port)
    assert terr.RP032_PLACEMENT_HOLE in port.codes()


@pytest.mark.parametrize("caps", ["plan", "half_certificate", "none"])
def test_analyze_matches_reference_on_decode_plan(decode_plan, caps):
    """With the cost graph bound: the memory certificate and the async
    overlap pass too; under caps at half the certificate, with the plan
    claiming feasibility, the same RP020 / RP040 errors."""
    prog, g = decode_plan.traced.program, decode_plan.traced.graph
    a, k = decode_plan.assignment, decode_plan.k
    kw = dict(graph=g, feasible=True, predicted_peaks=decode_plan.peak_mem)
    if caps == "plan":
        kw["mem_caps"] = decode_plan.devices.mem_caps()
    elif caps == "half_certificate":
        ctx = AnalysisContext(prog=prog, assignment=a, k=k,
                              schedule=cut_segments(prog, a, k=k), graph=g)
        kw["mem_caps"] = 0.5 * float(abstract_interpret(ctx).cert_peaks.max())
    ref = janalysis.analyze(prog, a, k, **kw)
    port = tanalysis.analyze(prog, a, k, **kw)
    _assert_same_report(ref, port)
    assert "memory" in port.passes_run and "overlap" in port.passes_run
    assert port.has_errors() == (caps == "half_certificate")
    if caps == "half_certificate":
        assert {terr.RP020_MEMORY_CAP_OVERFLOW,
                terr.RP040_TRANSFER_WINDOW_EXCEEDED} <= port.codes()


def test_plan_verify_matches_reference(decode_plan):
    plan = decode_plan
    rep = plan.verify()
    ref = janalysis.analyze(
        plan.traced.program, plan.assignment, plan.k,
        graph=plan.traced.graph, mem_caps=plan.devices.mem_caps(),
        feasible=bool(plan.feasible), predicted_peaks=plan.peak_mem)
    assert rep.passes_run == ["artifact"] + ref.passes_run
    assert _findings(rep) == _findings(ref)
    assert not rep.has_errors()
    assert plan.report.diagnostics["passes_run"] == rep.passes_run
    assert plan.verify() is rep                  # cached


def _port_case(prog, a, k, graph=None) -> MutableCase:
    """A mutable case holding the port's schedule (private copies)."""
    s = cut_segments(prog, a, k=k)
    sched = dataclasses.replace(
        s, segments=list(s.segments), node_refcount=dict(s.node_refcount),
        last_consumer_seg=dict(s.last_consumer_seg),
        prefetch=dict(s.prefetch),
        last_reader_on_dev=dict(s.last_reader_on_dev),
        producer_seg=dict(s.producer_seg))
    return MutableCase(prog=prog, assignment=np.array(a), k=k,
                       schedule=sched, graph=graph)


def _port_analyze(case):
    return tanalysis.analyze(case.prog, case.assignment, case.k,
                             schedule=case.schedule, graph=case.graph,
                             mem_caps=case.mem_caps, feasible=case.feasible)


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_caught_by_port_analyzer(name, decode_plan):
    mut = MUTATIONS[name]
    applied = False
    for seed in range(40):
        rng = np.random.default_rng(seed)
        if name in ("cap_overflow", "async_cap_overflow"):
            # needs byte annotations: the decode plan's cost graph
            case = _port_case(decode_plan.traced.program,
                              decode_plan.assignment, decode_plan.k,
                              graph=decode_plan.traced.graph)
        else:
            prog = random_program(rng, n_ops=16, p_multi=0.3)
            case = _port_case(prog, random_assignment(rng, prog, 3), 3)
        pre = _port_analyze(case)
        assert not pre.has_errors(), pre.render()
        if not apply_mutation(name, case, rng):
            continue
        applied = True
        rep = _port_analyze(case)
        assert rep.has_errors(), (name, seed)
        assert mut.expect_code in rep.codes(), (name, seed, rep.render())
        _assert_same_report(case.analyze(), rep)
        break
    assert applied, f"mutation {name} never applied in 40 seeds"


def test_save_and_execute_refuse_corrupt_plan(decode_plan, tmp_path):
    plan = dataclasses.replace(decode_plan,
                               assignment=decode_plan.assignment.copy())
    plan.assignment[max(plan.traced.program.program)] = plan.k  # a hole
    path = str(tmp_path / "bad.plan.json")
    with pytest.raises(terr.PlanValidationError) as e:
        plan.save(path)
    assert e.value.code == terr.RP107_VERIFICATION_FAILED
    assert "RP032" in str(e.value) and not os.path.exists(path)
    with pytest.raises(terr.PlanValidationError) as e:
        plan.execute(devices=["cpu"], device_map=[0] * plan.k)
    assert e.value.code == terr.RP107_VERIFICATION_FAILED


@pytest.mark.parametrize("seed", range(6))
def test_synth_matches_reference(seed):
    """The same seed gives the reference's program and assignment."""
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    kw = dict(n_ops=10 + 3 * seed, p_multi=0.3, n_consts=seed % 3)
    jp, tp = random_program(jr, **kw), tsynth.random_program(tr, **kw)
    assert isinstance(tp, TracedProgram)
    assert tp.program == jp.program and tp.n_outputs == jp.n_outputs
    assert tp.input_nodes == jp.input_nodes and tp.out_slots == jp.out_slots
    assert [(n, float(v)) for n, v in tp.const_nodes] == \
        [(n, float(v)) for n, v in jp.const_nodes]
    np.testing.assert_array_equal(tsynth.random_assignment(tr, tp, 3),
                                  random_assignment(jr, jp, 3))


def test_port_harness_registers_the_reference_mutations():
    assert {n: m.expect_code for n, m in tmutate.MUTATIONS.items()} == \
        {n: m.expect_code for n, m in MUTATIONS.items()}
    assert len(tmutate.MUTATIONS) == 12


def _harness_cases(name, seed, decode_plan):
    """(port case, reference case) for one seed: the decode plan with its
    cost graph for the cap mutations, else each package's random program
    and placement from the same seed."""
    if name in ("cap_overflow", "async_cap_overflow"):
        args = (decode_plan.traced.program, decode_plan.assignment,
                decode_plan.k)
        g = decode_plan.traced.graph
        return (tmutate.make_case(*args, graph=g),
                jmutate.make_case(*args, graph=g))
    cases = []
    for synth, harness in ((tsynth, tmutate), (jsynth, jmutate)):
        rng = np.random.default_rng(seed)
        prog = synth.random_program(rng, n_ops=16, p_multi=0.3)
        cases.append(harness.make_case(
            prog, synth.random_assignment(rng, prog, 3), 3))
    return tuple(cases)


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_port_harness_matches_reference(name, decode_plan):
    """For three seeds where the mutation applies: the port's harness
    applies it where the reference's does, the port's analyzer reports
    the expected code, and both packages' findings are the same."""
    applied = 0
    for seed in range(60):
        tcase, jcase = _harness_cases(name, seed, decode_plan)
        assert not tcase.analyze().has_errors()
        ok = tmutate.apply_mutation(name, tcase,
                                    np.random.default_rng(1000 + seed))
        assert ok == jmutate.apply_mutation(
            name, jcase, np.random.default_rng(1000 + seed))
        if not ok:
            continue
        rep = tcase.analyze()
        assert tmutate.MUTATIONS[name].expect_code in rep.codes(), \
            (seed, rep.render())
        _assert_same_report(jcase.analyze(), rep)
        applied += 1
        if applied == 3:
            break
    assert applied == 3, f"{name} applied {applied} times in 60 seeds"


def test_cli_exit_codes(decode_plan, tmp_path):
    """0 clean, 2 unloadable, 1 on a placement hole the verifier (not the
    loader) catches, and 1 with RP033 when ``--arch`` rebuilds a trace
    the plan was not made from."""
    path = decode_plan.save(str(tmp_path / "p.plan.json"))
    assert cli_main([path]) == 0
    assert cli_main([str(tmp_path / "missing.plan.json")]) == 2
    rep = str(tmp_path / "rep.json")
    assert cli_main([path, "--arch", "granite-8b", "--device", "cpu",
                     "--json", rep]) == 1
    with open(rep) as f:
        assert "RP033" in {d["code"] for d in json.load(f)["diagnostics"]}
    npz = str(tmp_path / "p.plan.npz")
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["assignment"] = arrays["assignment"].copy()
    arrays["assignment"][0] = -1
    with open(npz, "wb") as f:
        np.savez(f, **arrays)
    with open(path) as f:
        header = json.load(f)
    header["assignment_sha256"] = hashlib.sha256(
        np.ascontiguousarray(arrays["assignment"],
                             dtype=np.int64).tobytes()).hexdigest()
    with open(path, "w") as f:
        json.dump(header, f)
    assert cli_main([path, "--json", rep]) == 1
    with open(rep) as f:
        assert "RP032" in {d["code"] for d in json.load(f)["diagnostics"]}
