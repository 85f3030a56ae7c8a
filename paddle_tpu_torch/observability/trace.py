"""Span tracer: nested, thread-safe host spans (a trimmed copy of
``paddle_tpu/observability/trace.py``, kept to what the serving engine
and scheduler use).

Disabled (the default), ``span()`` and ``event()`` check one attribute
and return the shared ``NULL_SPAN`` / nothing: no allocation, no clock
read, no lock. Enabled, spans are stamped on ``perf_counter_ns`` and
export as chrome-trace JSON on the wall-clock base. Spans are context
managers only, so there is no begin/end pair to mismatch.

Env contract: ``PADDLE_TRACE`` truthy enables tracing at import;
``PADDLE_TRACE_DIR`` names the default export directory.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

TRACE_ENV = "PADDLE_TRACE"
TRACE_DIR_ENV = "PADDLE_TRACE_DIR"
_CAPACITY = 65536   # most-recent records kept; older ones are counted

# per-process clock anchor: wall_ns(t_perf) = _WALL0 + (t_perf - _PERF0)
_PERF0 = time.perf_counter_ns()
_WALL0 = time.time_ns()


def wall_ns(perf_ns):
    return _WALL0 + (perf_ns - _PERF0)


class _NullSpan:
    """Shared no-op span: the whole disabled-path cost."""

    __slots__ = ()
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One live span. Use only as a context manager (``with``)."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "tid", "t0",
                 "t1", "_tracer")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id = None
        self.tid = None
        self.t0 = None
        self.t1 = None

    def __enter__(self):
        stack = self._tracer._stack()
        self.parent_id = stack[-1].span_id if stack else None
        self.tid = threading.get_ident()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter_ns()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._push({
            "kind": "span", "name": self.name, "t0": self.t0,
            "t1": self.t1, "tid": self.tid, "span_id": self.span_id,
            "parent_id": self.parent_id, "attrs": self.attrs})
        return False


class Tracer:
    """Process-local span/event collector with chrome-trace export. The
    buffer is a most-recent-N ring; the export reports what it dropped."""

    def __init__(self, capacity=_CAPACITY):
        self.capacity = capacity
        self.enabled = False
        self._records = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._dir = None

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name, **attrs):
        """Open a span (context manager). Disabled: one attribute check."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def complete_span(self, name, t0_ns, t1_ns, **attrs):
        """Record a region the caller already timed (both endpoints are
        its own perf_counter_ns stamps) as a span, atomically at
        completion (the StepMeter's step). Disabled: one attribute
        check."""
        if not self.enabled:
            return
        stack = self._stack()
        self._push({"kind": "span", "name": name, "t0": int(t0_ns),
                    "t1": int(t1_ns), "tid": threading.get_ident(),
                    "span_id": next(self._ids),
                    "parent_id": stack[-1].span_id if stack else None,
                    "attrs": attrs})

    def event(self, name, **attrs):
        """Record an instant event. Disabled: one attribute check."""
        if not self.enabled:
            return
        t = time.perf_counter_ns()
        stack = self._stack()
        self._push({"kind": "event", "name": name, "t0": t, "t1": t,
                    "tid": threading.get_ident(), "span_id": None,
                    "parent_id": stack[-1].span_id if stack else None,
                    "attrs": attrs})

    def _push(self, rec):
        with self._lock:
            if len(self._records) == self.capacity:
                self.dropped += 1
            self._records.append(rec)

    def enable(self, dir=None):
        if dir is not None:
            self._dir = str(dir)
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._records.clear()
            self.dropped = 0

    def records(self):
        with self._lock:
            return list(self._records)

    def chrome_events(self):
        """Records as chrome-trace event dicts on the wall-clock base."""
        pid = os.getpid()
        out = []
        for r in self.records():
            args = dict(r["attrs"])
            if r["span_id"] is not None:
                args["span_id"] = r["span_id"]
            if r["parent_id"] is not None:
                args["parent_id"] = r["parent_id"]
            ev = {"name": r["name"], "pid": pid, "tid": r["tid"],
                  "cat": "paddle." + r["kind"],
                  "ts": wall_ns(r["t0"]) / 1000.0, "args": args}
            if r["kind"] == "event":
                ev["ph"] = "i"
                ev["s"] = "p"
            else:
                ev["ph"] = "X"
                ev["dur"] = (r["t1"] - r["t0"]) / 1000.0
            out.append(ev)
        return out

    def export(self, path=None):
        """Write this process's records as one chrome-trace JSON file.
        Returns the path."""
        if path is None:
            d = self._dir or os.environ.get(TRACE_DIR_ENV) or "."
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"trace.{os.getpid()}.json")
        payload = {"traceEvents": self.chrome_events(),
                   "displayTimeUnit": "ms"}
        if self.dropped:
            payload["droppedRecords"] = self.dropped
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


TRACER = Tracer()

span = TRACER.span
complete_span = TRACER.complete_span
event = TRACER.event
clear = TRACER.clear
export = TRACER.export


def enable(dir=None):
    return TRACER.enable(dir=dir)


def disable():
    TRACER.disable()


def load_trace(path):
    """Chrome-trace JSON file -> list of events (the traceEvents list)."""
    with open(path) as f:
        data = json.load(f)
    return data.get("traceEvents", [])


if str(os.environ.get(TRACE_ENV, "")).strip().lower() not in (
        "", "0", "false", "off", "no"):
    enable()
