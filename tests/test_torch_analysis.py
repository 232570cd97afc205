"""The port's static plan verifier against the JAX reference's: the same
diagnostics (code, severity, pass, node, segment, device) on random
synthetic programs and on the port's reduced granite-8b decode plan;
every mutation class of the reference's harness, applied to the port's
schedule, caught by the port's analyzer; and the facade refusing a
corrupt plan at save and at execute (RP107)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro import analysis as janalysis  # noqa: E402
from repro.analysis.mutate import (MUTATIONS, MutableCase,  # noqa: E402
                                   apply_mutation)
from repro.analysis.synth import (random_assignment,  # noqa: E402
                                  random_program)
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch import analysis as tanalysis  # noqa: E402
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
