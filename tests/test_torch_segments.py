"""The port's segment cutter against the JAX reference's, field by field:
on random synthetic programs and on the port's own reduced granite-8b
paged decode program (the cutters read its structure only), plus the
RP104 refusal when a placement has more PEs than devices."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.analysis.synth import (random_assignment,  # noqa: E402
                                  random_program)
from repro.core import segments as jseg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.core import errors as terr  # noqa: E402
from repro_torch.core import segments as tseg  # noqa: E402
from repro_torch.core.executor import (TracedProgram,  # noqa: E402
                                       validate_device_count)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import partition_for_serving  # noqa: E402

SEGMENT_FIELDS = ("sid", "device", "nodes", "inputs", "outputs",
                  "dead_inputs", "transfer_inputs")
SCHEDULE_FIELDS = ("k", "node_refcount", "last_consumer_seg",
                   "num_transfer_edges", "prefetch", "last_reader_on_dev",
                   "producer_seg")


def _port_program(prog) -> TracedProgram:
    """The same program as the port's TracedProgram (structure only)."""
    return TracedProgram(program=prog.program, n_outputs=prog.n_outputs,
                         input_nodes=list(prog.input_nodes),
                         const_nodes=list(prog.const_nodes),
                         out_slots=list(prog.out_slots),
                         out_tree=prog.out_tree,
                         in_tree_example=prog.in_tree_example)


def _assert_same_schedule(ref, port):
    assert port.num_segments == ref.num_segments
    assert port.segments_per_device() == ref.segments_per_device()
    for a, b in zip(ref.segments, port.segments):
        for f in SEGMENT_FIELDS:
            assert getattr(b, f) == getattr(a, f), (a.sid, f)
    for f in SCHEDULE_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("seed", range(6))
def test_cut_matches_reference_on_synth_programs(seed, k):
    rng = np.random.default_rng(seed)
    prog = random_program(rng, n_ops=int(rng.integers(8, 40)),
                          n_inputs=int(rng.integers(1, 4)))
    a = random_assignment(rng, prog, k)
    ref = jseg.cut_segments(prog, a, k=k)
    port = tseg.cut_segments(_port_program(prog), a, k=k)
    _assert_same_schedule(ref, port)
    if k == 1:
        assert port.num_segments == 1


def test_cut_without_assignment_is_one_segment():
    prog = random_program(np.random.default_rng(7), n_ops=20)
    ref = jseg.cut_segments(prog, None)
    port = tseg.cut_segments(_port_program(prog), None)
    _assert_same_schedule(ref, port)
    assert port.num_segments == 1 and port.num_transfer_edges == 0


@pytest.fixture(scope="module")
def decode_plan():
    """The port's reduced granite-8b decode step, partitioned at K=4."""
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return partition_for_serving(cfg, params, devices=4, device="cpu")


@pytest.mark.parametrize("which", ["plan", "random2", "random4"])
def test_cut_matches_reference_on_decode_program(decode_plan, which):
    prog = decode_plan.traced.program
    if which == "plan":
        a, k = decode_plan.assignment, decode_plan.k
    else:
        k = int(which[-1])
        a = np.random.default_rng(k).integers(
            0, k, size=decode_plan.n).astype(np.int64)
    ref = jseg.cut_segments(prog, a, k=k)
    port = tseg.cut_segments(prog, a, k=k)
    _assert_same_schedule(ref, port)
    assert port.num_segments > 1 and port.num_transfer_edges > 0
    # every program node in exactly one segment, on its assigned PE
    nodes = [n for s in port.segments for n in s.nodes]
    assert sorted(nodes) == sorted(prog.program)
    assert all(int(a[n]) == s.device for s in port.segments for n in s.nodes)


def test_device_affine_order_matches_reference(decode_plan):
    prog, a = decode_plan.traced.program, decode_plan.assignment
    assert tseg.device_topo_order(prog, a) == jseg.device_topo_order(prog, a)


def test_cut_refuses_fewer_devices_than_pes(decode_plan):
    prog, a = decode_plan.traced.program, decode_plan.assignment
    assert int(a.max()) == 3
    with pytest.raises(terr.PlanValidationError) as e:
        tseg.cut_segments(prog, a, k=2)
    assert e.value.code == terr.RP104_DEVICE_MISMATCH
    with pytest.raises(terr.PlanValidationError) as e:
        validate_device_count(a, ["cpu"] * 3)
    assert e.value.code == terr.RP104_DEVICE_MISMATCH
    validate_device_count(a, ["cpu"] * 4)
