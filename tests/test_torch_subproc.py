"""``repro_torch.conformance.subproc`` on the CPU: the conformance loop
run in a child process returns the record the same call makes in
process; ``run_json`` and ``run_py`` raise ``SubprocessError`` on a
nonzero exit or a missing payload; ``start_json`` lets the caller work
while the child runs and ``wait_json`` kills it at its timeout;
``child_env`` puts the running checkout's ``src`` first on
``PYTHONPATH``."""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.conformance import (JSON_MARK, run_conformance,  # noqa: E402
                                     spec_for)
from repro_torch.conformance.subproc import (SubprocessError,  # noqa: E402
                                             child_env, repo_src_path,
                                             run_arch_subprocess, run_json,
                                             run_py, start_json, wait_json)

#: the record's fields that do not depend on timing
CHECKS = ("ok", "violations", "arch", "device", "device_map", "folded",
          "num_layers", "num_nodes", "feasible", "makespan_s",
          "predicted_peak_bytes", "diagnostics", "num_segments",
          "segments_per_device", "cut_edges", "transfers",
          "sync_async_max_diff", "compiled_vs_interpreter_max_diff",
          "compiled_vs_reference_max_diff", "loss")


def test_run_arch_subprocess_returns_the_in_process_record():
    got = run_arch_subprocess("granite-8b", devices=4, device="cpu",
                              timeout=600)
    want = run_conformance(spec_for("granite-8b", devices=4), device="cpu")
    assert got["ok"] and not got["violations"]
    assert {k: got[k] for k in CHECKS} == {k: want[k] for k in CHECKS}


def test_run_json_raises_on_a_nonzero_exit():
    with pytest.raises(SubprocessError, match="exited 3"):
        run_json(["-c", "import sys; print('x'); sys.exit(3)"])


def test_run_json_raises_without_a_payload():
    with pytest.raises(SubprocessError, match="no CONFORMANCE_JSON"):
        run_json(["-c", "print('no marker here')"])


def test_run_json_parses_the_last_payload():
    code = (f"print('{JSON_MARK}' + '{{\"n\": 1}}'); "
            f"print('{JSON_MARK}' + '{{\"n\": 2}}'); print('done')")
    assert run_json(["-c", code]) == {"n": 2}


def test_start_json_runs_beside_the_caller_until_waited_for():
    proc = start_json(["-c", f"import time; time.sleep(0.5); "
                             f"print('{JSON_MARK}' + '{{\"n\": 3}}')"])
    assert proc.poll() is None          # still running: the caller works
    assert wait_json(proc, timeout=60) == {"n": 3}
    assert proc.returncode == 0


def test_wait_json_kills_the_child_at_its_timeout():
    proc = start_json(["-c", "import time; time.sleep(60)"])
    with pytest.raises(Exception, match="timed out"):
        wait_json(proc, timeout=1)
    assert proc.returncode is not None


def test_run_py_returns_stdout_and_raises_on_error():
    assert run_py("import repro_torch; print('ok')").strip() == "ok"
    with pytest.raises(SubprocessError, match="ZeroDivisionError"):
        run_py("1 / 0")


def test_child_env_puts_src_first_once():
    src = repo_src_path()
    env = child_env({"PYTHONPATH": "/elsewhere", "A": "1"})
    assert env["PYTHONPATH"].split(os.pathsep) == [src, "/elsewhere"]
    assert env["A"] == "1"
    assert child_env(env)["PYTHONPATH"] == env["PYTHONPATH"]
    assert child_env({})["PYTHONPATH"] == src
