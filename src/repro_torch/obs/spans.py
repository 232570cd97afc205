"""Structured spans and counters (port of the part of ``repro.obs.spans``
that the serving engine, the scheduler and the partitioner call).

One process-global :class:`Tracer` collects Chrome-trace-event-shaped
records. Tracing is off by default, and the disabled path is one
attribute load and one branch: ``span(name)`` without kwargs returns a
shared no-op singleton and allocates nothing. The trace exporter
(``repro.obs.trace``) is not ported yet, so the port collects events for
callers that read :attr:`Tracer.events` themselves.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Any

# Chrome trace-event phase codes.
PH_COMPLETE = "X"
PH_INSTANT = "i"
PH_COUNTER = "C"

#: pid of the in-process host lanes
HOST_PID = 0


class Tracer:
    """Collects trace events: ``(ph, name, cat, pid, tid, ts_us, dur_us,
    args)`` tuples. ``list.append`` is atomic under the GIL, so the
    record path takes no lock."""

    def __init__(self) -> None:
        self.enabled = False
        self.events: list[tuple] = []
        self._t0 = time.perf_counter()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def complete(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "repro", args: dict | None = None) -> None:
        self.events.append((PH_COMPLETE, name, cat, HOST_PID,
                            threading.get_ident(), ts_us, dur_us, args))

    def instant(self, name: str, cat: str = "repro",
                args: dict | None = None) -> None:
        self.events.append((PH_INSTANT, name, cat, HOST_PID,
                            threading.get_ident(), self.now_us(), 0.0,
                            args))

    def counter(self, name: str, values: dict, cat: str = "repro") -> None:
        self.events.append((PH_COUNTER, name, cat, HOST_PID,
                            threading.get_ident(), self.now_us(), 0.0,
                            dict(values)))

    def drain(self) -> list[tuple]:
        """Return and clear the collected events."""
        out, self.events = self.events, []
        return out


class _Span:
    """Live span: records a complete ("X") event on exit."""
    __slots__ = ("_tracer", "name", "cat", "args", "_start")

    def __init__(self, tracer: Tracer, name: str, cat: str,
                 args: dict | None) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        self._start = self._tracer.now_us()
        return self

    def __exit__(self, *exc) -> None:
        t = self._tracer
        t.complete(self.name, self._start, t.now_us() - self._start,
                   self.cat, self.args)


class _NullSpan:
    """Shared no-op span for the disabled path."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def enable(on: bool = True) -> None:
    _TRACER.enabled = bool(on)


def span(name: str, cat: str = "repro", **args: Any):
    """Context manager timing a named region; the shared no-op singleton
    when tracing is off."""
    t = _TRACER
    if not t.enabled:
        return _NULL_SPAN
    return _Span(t, name, cat, args or None)


def traced(name: str, cat: str = "repro"):
    """Decorator form of :func:`span` — wraps a whole function body.
    Disabled tracing costs one extra call frame and a branch."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t = _TRACER
            if not t.enabled:
                return fn(*a, **kw)
            with _Span(t, name, cat, None):
                return fn(*a, **kw)
        return wrapper
    return deco


def instant(name: str, cat: str = "repro", **args: Any) -> None:
    """Point-in-time marker (e.g. an eviction)."""
    t = _TRACER
    if t.enabled:
        t.instant(name, cat, args or None)


def counter(name: str, cat: str = "repro", **values: float) -> None:
    """Counter sample (e.g. KV block-pool occupancy)."""
    t = _TRACER
    if t.enabled:
        t.counter(name, values, cat)


__all__ = ["Tracer", "get_tracer", "enabled", "enable", "span",
           "traced", "instant", "counter"]
