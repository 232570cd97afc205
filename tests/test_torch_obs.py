"""The port's telemetry (``repro_torch.obs``) against the reference's
``repro.obs``: trace documents built through either ``TraceBuilder`` are
equal, ``validate_trace`` gives the reference's verdicts, a metrics file
written by either package reads in the other, the validator CLI's exit
codes, the shared statistics, the span tracer's metadata and its
``REPRO_TRACE`` export, and the allocation-free disabled path."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.obs.metrics as jmetrics  # noqa: E402
import repro.obs.spans as jspans  # noqa: E402
import repro.obs.stats as jstats  # noqa: E402
import repro.obs.trace as jtrace  # noqa: E402
import repro_torch.obs.metrics as tmetrics  # noqa: E402
import repro_torch.obs.spans as tspans  # noqa: E402
import repro_torch.obs.stats as tstats  # noqa: E402
import repro_torch.obs.trace as ttrace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (ph, name, cat, pid, tid, ts_us, dur_us, args) rows, as a Tracer holds
SPAN_EVENTS = [
    ("X", "partition", "core", 0, 11, 5.0, 40.0, {"k": 4}),
    ("i", "serving/evict", "serving", 0, 11, 9.0, 0.0, {"rid": 2}),
    ("C", "serving/pool", "serving", 0, 12, 3.0, 0.0, {"blocks": 7}),
    ("X", "decode", "serving", 0, 12, 1.0, -2.0, None),
]


def _build(mod, tracer_cls):
    """The same events through one package's TraceBuilder."""
    b = mod.TraceBuilder()
    b.process(mod.SERVING_PID, "serving")
    b.thread(mod.SERVING_PID, 0, "engine")
    b.thread(mod.SERVING_PID, 1, "request 0")
    b.complete(mod.SERVING_PID, 0, "decode_step", 30.0, 12.5,
               cat="serving", args={"batch": 3})
    b.complete(mod.SERVING_PID, 0, "prefill_batch", 10.0, 15.0,
               cat="serving", args={"admitted": 2, "rids": [0, 1]})
    b.instant(mod.SERVING_PID, 1, "evicted", 20.0, cat="serving",
              args={"rid": 0})
    b.counter(mod.SERVING_PID, 0, "pool", 25.0, {"blocks_in_use": 5})
    b.complete(mod.MEASURED_PID, 2, "seg3", 0.0, -1.0, cat="measured")
    tracer = tracer_cls()
    tracer.events = list(SPAN_EVENTS)
    tracer.name_thread("main", tid=11)
    assert b.add_spans(tracer) == len(SPAN_EVENTS)
    assert tracer.events == []
    return b.to_dict()


def test_trace_builders_give_equal_documents(tmp_path):
    jdoc = _build(jtrace, jspans.Tracer)
    tdoc = _build(ttrace, tspans.Tracer)
    assert tdoc == jdoc
    assert ttrace.validate_trace(tdoc) == []
    # a file the port writes loads in the reference, and back
    b = ttrace.TraceBuilder()
    b.complete(ttrace.HOST_PID, 0, "x", 1.0, 2.0)
    path = b.save(str(tmp_path / "t.json"))
    assert jtrace.load_trace(path) == ttrace.load_trace(path) == b.to_dict()


def test_lane_pids_are_the_references():
    for name in ("HOST_PID", "MEASURED_PID", "PREDICTED_PID",
                 "SERVING_PID"):
        assert getattr(ttrace, name) == getattr(jtrace, name)
    for name in ("PH_COMPLETE", "PH_INSTANT", "PH_COUNTER", "PH_METADATA"):
        assert getattr(tspans, name) == getattr(jspans, name)


_VALID = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
     "args": {"name": "host"}},
    {"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 1.0, "dur": 1.0},
    {"ph": "i", "name": "b", "pid": 0, "tid": 0, "ts": 1.0, "s": "t"},
]}
# the reference's malformed documents (tests/test_obs.py), one fault each
# and all together
MALFORMED = [
    {},
    {"traceEvents": {"not": "a list"}},
    {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 5.0,
         "dur": 1.0},
        {"ph": "X", "name": "b", "pid": 0, "tid": 0, "ts": 1.0,
         "dur": 1.0},                                   # ts decreases
        {"ph": "X", "name": "c", "pid": 0, "tid": 1, "ts": 0.0},  # no dur
        {"ph": "i", "pid": 0, "tid": 1, "ts": "soon"},  # no name, bad ts
    ]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 0, "tid": 0,
                      "ts": 0.0, "dur": -1.0}]},
    {"traceEvents": [{"ph": "X", "name": "a", "tid": 0, "ts": float("nan"),
                      "dur": 1.0}]},
    {"traceEvents": ["not an event"]},
    _VALID,
]


@pytest.mark.parametrize("doc", MALFORMED,
                         ids=[f"doc{i}" for i in range(len(MALFORMED))])
def test_validate_trace_gives_the_references_verdicts(doc):
    assert ttrace.validate_trace(doc) == jtrace.validate_trace(doc)


def test_validate_trace_unreadable_path(tmp_path):
    p = tmp_path / "t.json"
    p.write_text("{not json")
    got = ttrace.validate_trace(str(p))
    assert got and "unreadable" in got[0]
    assert len(got) == len(jtrace.validate_trace(str(p)))


def test_predicted_vs_measured_matches_reference():
    docs = []
    for mod in (jtrace, ttrace):
        b = mod.TraceBuilder()
        b.complete(mod.MEASURED_PID, 0, "seg0", 0.0, 30.0)
        b.complete(mod.MEASURED_PID, 1, "seg1", 5.0, 10.0)
        b.complete(mod.PREDICTED_PID, 0, "seg0", 0.0, 15.0)
        b.complete(mod.PREDICTED_PID, 1, "seg9", 1.0, 0.0)
        docs.append(b.to_dict())
    assert docs[0] == docs[1]
    rows = ttrace.predicted_vs_measured(docs[1])
    assert rows == jtrace.predicted_vs_measured(docs[0])
    assert [r["name"] for r in rows] == ["seg0"]
    assert rows[0]["ratio"] == pytest.approx(2.0)


@pytest.mark.parametrize("writer,reader", [(tmetrics, jmetrics),
                                           (jmetrics, tmetrics)],
                         ids=["port_to_reference", "reference_to_port"])
def test_metrics_file_reads_in_the_other_package(tmp_path, writer, reader):
    reg = writer.MetricsRegistry("launch_serve", meta={"arch": "tiny"})
    reg.record("tokens_per_s", 12.5)
    reg.group("levels", [{"concurrency": 1, "ttft_p50_s": None}])
    path = reg.save(str(tmp_path / "m.json"))
    back = reader.MetricsRegistry.load(path)
    assert back.source == "launch_serve" and back.meta == {"arch": "tiny"}
    assert back.metrics == reg.metrics == reader.read_metrics(path)
    assert reader.validate_file(path) == []


def test_metrics_envelope_constants_and_refusals(tmp_path):
    assert tmetrics.METRICS_FORMAT == jmetrics.METRICS_FORMAT
    assert tmetrics.METRICS_SCHEMA_VERSION == \
        jmetrics.METRICS_SCHEMA_VERSION
    bad = {"format": "repro-metrics", "schema_version": 99, "source": "",
           "meta": [], "metrics": {"x": float("inf"), 1: object()}}
    assert tmetrics.validate_doc(bad) == jmetrics.validate_doc(bad)
    reg = tmetrics.MetricsRegistry("x")
    reg.record("nan", float("nan"))
    with pytest.raises(tmetrics.MetricsValidationError):
        reg.save(str(tmp_path / "bad.json"))
    assert tmetrics.read_metrics({"legacy": 1}) == {"legacy": 1}


def test_metrics_cli_exit_codes(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps(tmetrics.wrap_metrics("cli", {"x": 1})))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"format": "other"}))
    assert tmetrics.main([str(good)]) == 0
    assert tmetrics.main([str(good), str(bad)]) == 1
    assert tmetrics.main([]) == 2
    out = capsys.readouterr().out
    assert f"ok      {good}" in out and f"INVALID {bad}" in out
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    codes = [subprocess.run([sys.executable, "-m", "repro_torch.obs", *a],
                            env=env, capture_output=True, text=True,
                            timeout=120).returncode
             for a in ([str(good)], [str(bad)], [])]
    assert codes == [0, 1, 2]


@pytest.mark.parametrize("xs", [[], [None], [0.0, 0.0], [7.0],
                                [1.0, 2.0, 3.0, 100.0],
                                [None, 2.0, 2.0, 2.0], [0.3, 0.1, 0.2]])
def test_stats_match_reference(xs):
    assert tstats.median(xs) == jstats.median(xs)
    assert tstats.dispersion(xs) == jstats.dispersion(xs)
    assert tstats.latency_summary(xs, prefix="t_") == \
        jstats.latency_summary(xs, prefix="t_")


def test_tracer_metadata_and_clear():
    t = tspans.Tracer()
    assert t.epoch() == t._t0
    t.name_thread("worker", tid=7)
    t.name_thread("main")
    names = t.thread_names()
    assert names[7] == "worker" and "main" in names.values()
    t.complete("x", 0.0, 1.0, tid=7)
    assert t.events[0][4] == 7
    t.clear()
    assert t.events == [] and t.thread_names() == names


def _run(code: str, **env_extra) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
    if "REPRO_TRACE" not in env_extra:
        env.pop("REPRO_TRACE", None)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)


def test_disabled_span_allocates_nothing():
    """A fresh interpreter, so that no other thread allocates."""
    r = _run("import tracemalloc\n"
             "from repro_torch.obs import spans\n"
             "def hot(n):\n"
             "    for _ in range(n):\n"
             "        with spans.span('hot'):\n"
             "            pass\n"
             "hot(10)\n"
             "tracemalloc.start()\n"
             "hot(1000)\n"
             "current, _peak = tracemalloc.get_traced_memory()\n"
             "assert current == 0, f'{current} bytes'\n"
             "assert spans.get_tracer().events == []\n"
             "print('ZERO_ALLOC_OK')\n")
    assert r.returncode == 0, r.stderr
    assert "ZERO_ALLOC_OK" in r.stdout


def test_repro_trace_env_exports_at_exit(tmp_path):
    path = tmp_path / "env.trace.json"
    r = _run("from repro_torch.obs import spans\n"
             "with spans.span('work', cat='t'):\n"
             "    spans.instant('mark')\n", REPRO_TRACE=str(path))
    assert r.returncode == 0, r.stderr
    doc = ttrace.load_trace(str(path))
    assert ttrace.validate_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") != "M"}
    assert names == {"work", "mark"}
