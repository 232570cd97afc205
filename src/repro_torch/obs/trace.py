"""Chrome trace-event / Perfetto JSON export (port of
``repro.obs.trace``).

The emitted document is the plain Chrome trace-event format::

    {"traceEvents": [...], "displayTimeUnit": "ms"}

loadable in https://ui.perfetto.dev (drag-and-drop the JSON) or
``chrome://tracing``. Lane layout, the reference's:

* pid 0 — **host**: live spans/instants/counters collected by
  :mod:`.spans`, one thread lane per Python thread.
* pid 1 — **measured**: the compiled runtime's per-segment timeline
  (:meth:`CompiledRuntime.measure_timeline`), one thread lane per PE;
  each ``seg{sid}`` event spans the segment's own run on its PE's
  stream, from ready (its inputs from other PEs arrived) to done. On
  CUDA both ends are the card's clock (CUDA events); the host's
  dispatch time rides along in ``args``. On the CPU they are host
  timestamps.
* pid 2 — **predicted**: the overlap emulator's schedule for the same
  segments (``segment_cost_graph`` + ``emulate_overlap``), one lane per
  PE, same ``seg{sid}`` names, so :func:`predicted_vs_measured` pairs
  them by name across the two pids.
* pid 3 — **serving**: the engine's lane and one lane per request
  (``ServingEngine(trace=)``).

Every complete ("X") event carries pid/tid/ts/dur/ph and per-lane
nondecreasing timestamps (events are sorted at export);
:func:`validate_trace` checks exactly that contract.
"""
from __future__ import annotations

import json
from typing import Any

from .spans import (HOST_PID, PH_COMPLETE, PH_COUNTER, PH_INSTANT,
                    Tracer, get_tracer)

#: reserved process ids of the exported lane groups
MEASURED_PID = 1
PREDICTED_PID = 2
SERVING_PID = 3


class TraceBuilder:
    """Accumulates trace events + lane metadata; emits the JSON doc."""

    def __init__(self) -> None:
        self._events: list[dict] = []
        self._procs: dict[int, str] = {}
        self._threads: dict[tuple[int, int], str] = {}

    # -- lane naming ----------------------------------------------------
    def process(self, pid: int, name: str) -> None:
        self._procs[int(pid)] = str(name)

    def thread(self, pid: int, tid: int, name: str) -> None:
        self._threads[(int(pid), int(tid))] = str(name)

    # -- events ---------------------------------------------------------
    def complete(self, pid: int, tid: int, name: str, ts_us: float,
                 dur_us: float, cat: str = "repro",
                 args: dict | None = None) -> None:
        ev = {"ph": PH_COMPLETE, "name": str(name), "cat": str(cat),
              "pid": int(pid), "tid": int(tid), "ts": float(ts_us),
              "dur": max(float(dur_us), 0.0)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, pid: int, tid: int, name: str, ts_us: float,
                cat: str = "repro", args: dict | None = None) -> None:
        ev = {"ph": PH_INSTANT, "name": str(name), "cat": str(cat),
              "pid": int(pid), "tid": int(tid), "ts": float(ts_us),
              "s": "t"}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, pid: int, tid: int, name: str, ts_us: float,
                values: dict, cat: str = "repro") -> None:
        self._events.append(
            {"ph": PH_COUNTER, "name": str(name), "cat": str(cat),
             "pid": int(pid), "tid": int(tid), "ts": float(ts_us),
             "args": {k: float(v) for k, v in values.items()}})

    def add_spans(self, tracer: Tracer | None = None,
                  pid: int = HOST_PID, pid_name: str = "host",
                  drain: bool = True) -> int:
        """Fold a :class:`Tracer`'s buffered events into this trace
        (one thread lane per recording thread). Returns the count."""
        tracer = tracer or get_tracer()
        events = tracer.drain() if drain else list(tracer.events)
        if not events:
            return 0
        self.process(pid, pid_name)
        names = tracer.thread_names()
        seen: set[int] = set()
        for ph, name, cat, _pid, tid, ts, dur, args in events:
            if tid not in seen:
                seen.add(tid)
                self.thread(pid, tid, names.get(tid, f"thread-{tid}"))
            if ph == PH_COMPLETE:
                self.complete(pid, tid, name, ts, dur, cat, args)
            elif ph == PH_COUNTER:
                self.counter(pid, tid, name, ts, args or {}, cat)
            else:
                self.instant(pid, tid, name, ts, cat, args)
        return len(events)

    # -- emission -------------------------------------------------------
    def to_dict(self) -> dict:
        meta: list[dict] = []
        for pid, name in sorted(self._procs.items()):
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "args": {"name": name}})
            meta.append({"ph": "M", "name": "process_sort_index",
                         "pid": pid, "tid": 0,
                         "args": {"sort_index": pid}})
        for (pid, tid), name in sorted(self._threads.items()):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": name}})
        # per-lane nondecreasing ts by construction: stable-sort within
        # each (pid, tid) lane, preserving global insertion order across
        # lanes only as a secondary effect
        events = sorted(self._events,
                        key=lambda e: (e["pid"], e["tid"], e["ts"]))
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


def export_spans(path: str, tracer: Tracer | None = None) -> str:
    """Dump the live span buffer as a standalone trace file (the
    ``REPRO_TRACE=/path.json`` atexit hook)."""
    b = TraceBuilder()
    b.add_spans(tracer)
    return b.save(path)


# ---------------------------------------------------------------------------
# plan traces: measured + predicted device lanes
# ---------------------------------------------------------------------------
def add_measured_lanes(b: TraceBuilder, rt, timeline: dict,
                       predicted_s: dict | None = None) -> None:
    """Measured lanes from a ``measure_timeline`` timeline: one
    ``seg{sid}`` complete event per segment, ready→done, on its PE's
    thread lane. ``transfer_wait`` lands as a counter so input stalls
    are visible next to the segments they delayed."""
    b.process(MEASURED_PID, "measured (runtime)")
    k = len(rt.devices)
    for d in range(k):
        b.thread(MEASURED_PID, d, f"device {d}")
    dispatch = timeline.get("dispatch_s", [])
    done = timeline.get("done_s", [])
    ready = timeline.get("ready_s", [])
    waits = timeline.get("transfer_wait_s", [])
    segs = rt.schedule.segments
    for i, seg in enumerate(segs):
        if i >= len(ready):
            break
        t0 = float(ready[i])
        t1 = float(done[i]) if i < len(done) else t0
        args: dict[str, Any] = {
            "segment": int(seg.sid), "device": int(seg.device),
            "nodes": len(seg.nodes), "measured_s": max(t1 - t0, 0.0),
            "ready_s": t0, "done_s": t1}
        if i < len(dispatch):
            args["dispatch_s"] = float(dispatch[i])
        if i < len(waits):
            args["transfer_wait_s"] = float(waits[i])
        if predicted_s is not None and seg.sid in predicted_s:
            args["predicted_s"] = float(predicted_s[seg.sid])
        b.complete(MEASURED_PID, seg.device, f"seg{seg.sid}",
                   t0 * 1e6, (t1 - t0) * 1e6, cat="measured", args=args)
        if i < len(waits) and waits[i] > 0:
            b.counter(MEASURED_PID, seg.device, "transfer_wait_s",
                      t0 * 1e6, {"seconds": float(waits[i])},
                      cat="measured")


def add_predicted_lanes(b: TraceBuilder, rt, graph, device_model,
                        k: int) -> dict:
    """Predicted lanes: lift the segment schedule to a cost
    graph, run the overlap emulator, and emit one ``seg{sid}`` event
    per segment at its predicted [st, ft). Returns ``{sid:
    predicted_seconds}`` so the measured lanes can cross-reference."""
    from ..core.emulator import emulate_overlap, segment_cost_graph
    sg, seg_assign = segment_cost_graph(rt.prog, rt.schedule, graph,
                                        device_model)
    ov = emulate_overlap(sg, seg_assign, k,
                         comm_streams=device_model.comm_streams)
    b.process(PREDICTED_PID, "predicted (emulator)")
    for d in range(k):
        b.thread(PREDICTED_PID, d, f"device {d}")
    pred: dict[int, float] = {}
    for sid in range(sg.n):
        st, ft = float(ov.st[sid]), float(ov.ft[sid])
        pred[sid] = ft - st
        b.complete(
            PREDICTED_PID, int(seg_assign[sid]), f"seg{sid}",
            st * 1e6, (ft - st) * 1e6, cat="predicted",
            args={"segment": sid, "device": int(seg_assign[sid]),
                  "predicted_s": ft - st, "ready_s": float(ov.ready[sid]),
                  "queue_wait_s": float(ov.queue_wait[sid])})
    return pred


def build_plan_trace(plan, rt, timeline: dict,
                     include_spans: bool = True) -> TraceBuilder:
    """The merged plan trace behind ``plan.execute(trace=...)``:
    predicted emulator lanes + measured runtime lanes for the same
    segments, plus any live host spans."""
    b = TraceBuilder()
    pred = None
    traced = plan.traced
    if traced is not None and traced.device_model is not None:
        pred = add_predicted_lanes(b, rt, traced.graph,
                                   traced.device_model, plan.k)
    add_measured_lanes(b, rt, timeline, predicted_s=pred)
    if include_spans and get_tracer().enabled:
        b.add_spans()
    return b


# ---------------------------------------------------------------------------
# reading traces back
# ---------------------------------------------------------------------------
def load_trace(doc_or_path) -> dict:
    if isinstance(doc_or_path, str):
        with open(doc_or_path) as f:
            return json.load(f)
    return doc_or_path


def validate_trace(doc_or_path) -> list[str]:
    """Shape-check a trace document; returns a list of problems (empty
    = valid). The contract: a ``traceEvents`` list where every event
    has ph/name/pid/tid, non-metadata events have a finite ``ts``,
    complete events have ``dur >= 0``, and within each (pid, tid) lane
    the non-metadata timestamps are nondecreasing in array order."""
    problems: list[str] = []
    try:
        doc = load_trace(doc_or_path)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable trace: {e}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts: dict[tuple, float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for key in ("ph", "name", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i} ({ev.get('name')}): "
                                f"missing {key!r}")
        ph = ev.get("ph")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts != ts:
            problems.append(f"event {i} ({ev.get('name')}): bad ts {ts!r}")
            continue
        if ph == PH_COMPLETE:
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or not dur >= 0:
                problems.append(f"event {i} ({ev.get('name')}): "
                                f"X event needs dur >= 0, got {dur!r}")
        lane = (ev.get("pid"), ev.get("tid"))
        if ts < last_ts.get(lane, float("-inf")):
            problems.append(
                f"event {i} ({ev.get('name')}): ts {ts} decreases "
                f"within lane pid={lane[0]} tid={lane[1]}")
        last_ts[lane] = ts
    return problems


def predicted_vs_measured(doc_or_path) -> list[dict]:
    """Recover per-segment predicted/measured durations from a plan
    trace by matching event names across the predicted and measured
    pids. Returns one record per segment present in both::

        {"name": "seg3", "device": 1, "predicted_s": ...,
         "measured_s": ..., "ratio": measured/predicted or None}
    """
    doc = load_trace(doc_or_path)
    by_pid: dict[int, dict[str, dict]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != PH_COMPLETE:
            continue
        by_pid.setdefault(ev["pid"], {})[ev["name"]] = ev
    pred = by_pid.get(PREDICTED_PID, {})
    meas = by_pid.get(MEASURED_PID, {})
    out = []
    for name in sorted(set(pred) & set(meas),
                       key=lambda s: (len(s), s)):
        p = pred[name]["dur"] / 1e6
        m = meas[name]["dur"] / 1e6
        out.append({"name": name,
                    "device": meas[name].get("tid"),
                    "predicted_s": p, "measured_s": m,
                    "ratio": (m / p) if p > 0 else None})
    return out


__all__ = ["TraceBuilder", "export_spans", "build_plan_trace",
           "add_measured_lanes", "add_predicted_lanes", "load_trace",
           "validate_trace", "predicted_vs_measured", "MEASURED_PID",
           "PREDICTED_PID", "SERVING_PID"]
