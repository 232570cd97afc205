"""The port's serving scenario (``repro_torch.conformance.matrix.
run_serving_conformance``) against the reference's on the CPU: reduced
granite-8b (float32), partitioned at K=4 and folded onto the CPU. The
scenario holds (ok, preemption forced, 0 leaked blocks in both
schedules, 4 requests completed, every pool leaf on its PE's device);
its sequential reference, on weights made by the JAX package from seed
0 and carried across, equals the reference's ``prefill`` /
``decode_step`` token for token (a divergence allowed only where the
reference's top-2 gap is under ``NEAR_TIE``, after which the request is
not compared); its
record carries every key of the reference's; the CLI's ``--serving`` and
``--trace`` in a child process; ``matrix_archs`` equals the
reference's."""
import ast
import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.conformance.matrix as jmatrix  # noqa: E402
import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.conformance import matrix  # noqa: E402
from repro_torch.conformance.subproc import run_json  # noqa: E402
from repro_torch.obs.trace import SERVING_PID, load_trace  # noqa: E402

#: a reference top-2 logit gap under which float32 sums in another order
#: may pick the other token
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def carried():
    """(port config, port params, reference config, reference params):
    reduced granite-8b from ``jax.random.PRNGKey(0)``."""
    jc = jcfg.reduced(jcfg.get_config("granite-8b"))
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return tcfg.reduced(tcfg.get_config("granite-8b")), tp, jc, jp


@pytest.fixture(scope="module")
def scenario():
    return matrix.run_serving_conformance("granite-8b", devices=4, seed=0,
                                          device="cpu")


def test_matrix_archs_equal_reference():
    assert matrix.matrix_archs() == jmatrix.matrix_archs()
    assert len(matrix.matrix_archs()) == 11


def test_scenario_holds_on_the_cpu(scenario):
    rec = scenario
    assert rec["ok"], rec["violations"]
    assert rec["evictions"] > 0
    assert rec["leaked_blocks_evict"] == rec["leaked_blocks_shuffled"] == 0
    assert rec["completed"] == rec["serving_stats"]["completed"] == 4
    assert rec["folded"] and rec["device_map"] == [0, 0, 0, 0]
    assert rec["pool_pes"] and set(rec["pool_pes"]) <= set(range(4))
    assert rec["pool_devices"] == ["cpu"]
    assert sorted(rec["admission_order"]) == [0, 1, 2, 3]
    assert rec["reference_min_gap"] > NEAR_TIE
    assert rec["flash_launches"] == {"total": 0, "sm90": 0, "fma": 0}


_PREFILL = jax.jit(jm.prefill, static_argnums=(0, 3))
_DECODE = jax.jit(jm.decode_step, static_argnums=(0,))


def _reference_tokens(jc, jp, prompt, n_new):
    """The reference scenario's sequential decode, with each token's
    top-2 gap."""
    logits, caches = _PREFILL(jc, jp, {"tokens": jnp.asarray(
        prompt[None, :])}, matrix.SERVING_REFERENCE_LEN)
    toks, gaps = [], []
    pos = len(prompt)
    while True:
        row = np.sort(np.asarray(logits[0, -1]))
        gaps.append(float(row[-1] - row[-2]))
        toks.append(int(jnp.argmax(logits[0, -1])))
        if len(toks) == n_new:
            return toks, gaps
        logits, caches = _DECODE(
            jc, jp, caches, jnp.asarray([[toks[-1]]], jnp.int32),
            jnp.int32(pos))
        pos += 1


def test_sequential_tokens_equal_reference(carried):
    tc, tp, jc, jp = carried
    prompts = matrix.serving_prompts(tc, np.random.default_rng(0))
    assert [len(p) for p in prompts] == [
        len(p) for p in matrix.serving_prompts(jc, np.random.default_rng(
            0))]
    compared = 0
    for p in prompts:
        got, _ = matrix.sequential_tokens(tc, tp, p,
                                          matrix.SERVING_NEW_TOKENS, "cpu")
        want, gaps = _reference_tokens(jc, jp, p, matrix.SERVING_NEW_TOKENS)
        for g, w, gap in zip(got, want, gaps):
            if g != w:
                assert gap < NEAR_TIE, (got, want, gaps)
                break
            compared += 1
    assert compared >= 30


def _reference_record_keys() -> set[str]:
    """Keys the reference's ``run_serving_conformance`` writes: the ones
    its record starts with and every ``rec["..."] = ...``."""
    tree = ast.parse(inspect.getsource(jmatrix.run_serving_conformance))
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.AnnAssign) and isinstance(node.value,
                                                          ast.Dict):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name) and t.value.id == "rec":
                    keys.add(t.slice.value)
    return keys


def test_record_keys_cover_the_reference(scenario):
    want = _reference_record_keys()
    assert {"evictions", "leaked_blocks_evict", "leaked_blocks_shuffled",
            "admission_order", "pool_devices", "serving_stats",
            "violations", "ok"} <= want
    assert want - {"trace_path"} <= set(scenario)
    assert {"device_map", "folded", "pool_pes"} <= set(scenario)


def test_cli_serving_with_trace_in_a_child(tmp_path):
    path = str(tmp_path / "serving.trace.json")
    rec = run_json(["-m", "repro_torch.conformance", "--arch", "granite-8b",
                    "--serving", "--devices", "4", "--device", "cpu",
                    "--trace", path], timeout=600)
    assert rec["ok"], rec["violations"]
    assert rec["evictions"] > 0 and rec["trace_path"] == path
    assert rec["leaked_blocks_evict"] == rec["leaked_blocks_shuffled"] == 0
    doc = load_trace(path)
    lanes = sorted(e["args"]["name"] for e in doc["traceEvents"]
                   if e.get("name") == "thread_name"
                   and e["pid"] == SERVING_PID)
    assert lanes == ["engine"] + [f"request {i}" for i in range(4)]
    evicted = sum(e.get("name") == "evicted" for e in doc["traceEvents"])
    assert evicted == rec["evictions"]


def test_trace_problems_name_a_missing_lane_and_wrong_evictions(tmp_path):
    from repro_torch.obs.trace import TraceBuilder
    b = TraceBuilder()
    b.process(SERVING_PID, "serving")
    b.thread(SERVING_PID, 0, "engine")
    b.thread(SERVING_PID, 1, "request 0")
    b.instant(SERVING_PID, 1, "evicted", 5.0, cat="serving")
    path = b.save(str(tmp_path / "t.json"))
    assert matrix._serving_trace_problems(path, 1, 1) == []
    problems = matrix._serving_trace_problems(path, 2, 2)
    assert any("serving lanes" in p for p in problems)
    assert any("1 evicted instants" in p for p in problems)
    with open(path, "w") as f:
        json.dump({"traceEvents": [{"ph": "X"}]}, f)
    assert matrix._serving_trace_problems(path, 1, 0)


def test_cli_trace_reaches_the_training_loop(tmp_path, capsys):
    path = str(tmp_path / "train.trace.json")
    assert matrix.main(["--arch", "granite-8b", "--devices", "4",
                        "--device", "cpu", "--trace", path]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(out[len(matrix.JSON_MARK):])
    assert rec["ok"] and rec["trace_path"] == path
    assert rec["trace_segments_matched"] > 0
