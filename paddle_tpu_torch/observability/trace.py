"""Span tracer: nested, thread-safe host spans (counterpart:
``paddle_tpu/observability/trace.py``, whose names and behaviour it keeps).

1. Near-zero cost when disabled (the default): ``span()`` and ``event()``
   check one attribute and return the shared ``NULL_SPAN`` / nothing: no
   allocation, no clock read, no lock. The engine, the store client and
   the train step stay instrumented unconditionally.
2. Stdlib only, no package-relative import: the elastic agent and the
   launcher's processes import it without torch.
3. One timeline across processes. Spans are stamped on
   ``perf_counter_ns`` with a per-process (wall, perf) anchor pair taken
   at import, so an export carries either wall-clock microseconds
   (``base="wall"``: every process of a run lands on one chrome timeline)
   or the perf base (``base="perf"``) that ``paddle_tpu_torch.profiler``'s
   host events and its aligned device events use.

Env contract: ``PADDLE_TRACE`` truthy enables tracing at import;
``PADDLE_TRACE_DIR`` names the export directory, and when both are set
the process exports ``trace.<pid>.json`` at exit; ``PADDLE_TRACE_CAPACITY``
bounds the ring of records kept (65536 by default). ``merge_traces(dir)``
stitches the shards into one chrome-trace JSON.

Spans are context managers only: there is no begin()/end() pair to
mismatch.
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
CAPACITY_ENV = "PADDLE_TRACE_CAPACITY"

_DEFAULT_CAPACITY = 65536  # most-recent records kept (a multi-day run
# with per-step spans must not grow memory without bound — same
# rationale as the flight ring; dropped count lands in the export)

# per-process clock anchor: wall_ns(t_perf) = _WALL0 + (t_perf - _PERF0).
# Captured once, together, so the pair is consistent to ~µs.
_PERF0 = time.perf_counter_ns()
_WALL0 = time.time_ns()


def wall_ns(perf_ns):
    """Wall-clock ns of a perf_counter_ns stamp (cross-process merges)."""
    return _WALL0 + (perf_ns - _PERF0)


def _truthy(v):
    return str(v).strip().lower() not in ("", "0", "false", "off", "no")


class _NullSpan:
    """Shared no-op span: the entire disabled-path cost is returning
    this singleton (plus the caller's ``with`` protocol)."""

    __slots__ = ()
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attrs(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One live span. Use only as a context manager (``with``)."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "tid",
                 "t0", "t1", "c0", "c1", "_tracer")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id = None
        self.tid = None
        self.t0 = None
        self.t1 = None
        self.c0 = None
        self.c1 = None

    def set_attrs(self, **attrs):
        """Attach/overwrite attributes mid-span (recorded at exit)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = self._tracer._stack()
        self.parent_id = stack[-1].span_id if stack else None
        self.tid = threading.get_ident()
        stack.append(self)
        self.c0 = time.process_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter_ns()
        self.c1 = time.process_time_ns()
        stack = self._tracer._stack()
        # tolerate a foreign-thread exit (never corrupt another span)
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._complete(self)
        return False


class Tracer:
    """Process-local span/event collector with chrome-trace export.
    The buffer is a most-recent-N ring (``PADDLE_TRACE_CAPACITY``,
    default 65536): long traced runs stay memory-bounded, and the
    export reports how many older records rotation dropped."""

    def __init__(self, capacity=None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(CAPACITY_ENV,
                                              _DEFAULT_CAPACITY))
            except ValueError:
                capacity = _DEFAULT_CAPACITY
        self.capacity = capacity
        self.enabled = False
        self._records = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._sinks = []
        self._dir = None
        self._atexit_armed = False

    # -- recording -----------------------------------------------------------
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
        """Record an ALREADY-MEASURED region as a span: both endpoints
        are perf_counter_ns stamps the caller captured itself. For
        meters that time a region anyway (perf.StepMeter): recording is
        atomic at completion, so — unlike a begin()/end() pair — nothing
        can leak open across early exits. Disabled: one attribute
        check."""
        if not self.enabled:
            return
        stack = self._stack()
        rec = {"kind": "span", "name": name, "t0": int(t0_ns),
               "t1": int(t1_ns), "tid": threading.get_ident(),
               "span_id": next(self._ids),
               "parent_id": stack[-1].span_id if stack else None,
               "attrs": attrs}
        self._push(rec)

    def event(self, name, **attrs):
        """Record an instant event. Disabled: one attribute check."""
        if not self.enabled:
            return
        t = time.perf_counter_ns()
        stack = self._stack()
        rec = {"kind": "event", "name": name, "t0": t, "t1": t,
               "tid": threading.get_ident(), "span_id": None,
               "parent_id": stack[-1].span_id if stack else None,
               "attrs": attrs}
        self._push(rec)

    def _complete(self, span):
        rec = {"kind": "span", "name": span.name, "t0": span.t0,
               "t1": span.t1, "tid": span.tid, "span_id": span.span_id,
               "parent_id": span.parent_id, "attrs": span.attrs}
        if span.c0 is not None and span.c1 is not None:
            rec["c0"], rec["c1"] = span.c0, span.c1
        self._push(rec)

    def _push(self, rec):
        with self._lock:
            if len(self._records) == self.capacity:
                self.dropped += 1
            self._records.append(rec)
        for sink in self._sinks:
            try:
                sink(rec)
            # a failing sink (a full flight-recorder disk) must not break
            # the traced code; the record is already in the buffer
            except Exception:
                pass

    def add_sink(self, fn):
        """``fn(record_dict)`` per completed span/event (the flight ring's
        feed, wired in the package ``__init__``)."""
        self._sinks.append(fn)

    # -- lifecycle -----------------------------------------------------------
    def enable(self, dir=None):
        """Turn recording on; ``dir`` (or $PADDLE_TRACE_DIR) additionally
        arms an atexit auto-export of trace.<pid>.json."""
        if dir is not None:
            self._dir = str(dir)
        elif self._dir is None:
            self._dir = os.environ.get(TRACE_DIR_ENV) or None
        self.enabled = True
        if self._dir and not self._atexit_armed:
            import atexit
            atexit.register(self._atexit_export)
            self._atexit_armed = True
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

    def _atexit_export(self):
        try:
            if self._records:
                self.export()
        # best effort at exit: a failed export must not turn a clean
        # exit into a failure
        except Exception:
            pass

    # -- export --------------------------------------------------------------
    def chrome_events(self, base="wall"):
        """Records as chrome-trace event dicts. ``base="wall"`` stamps
        wall-clock µs (cross-process merge); ``base="perf"`` stamps
        perf_counter µs (the `profiler` host-event base, for one
        in-process timeline with its aligned device events)."""
        pid = os.getpid()
        out = []
        for r in self.records():
            t0 = r["t0"] if base == "perf" else wall_ns(r["t0"])
            args = dict(r["attrs"])
            if r["span_id"] is not None:
                args["span_id"] = r["span_id"]
            if r["parent_id"] is not None:
                args["parent_id"] = r["parent_id"]
            ev = {"name": r["name"], "pid": pid, "tid": r["tid"],
                  "cat": "paddle." + r["kind"], "ts": t0 / 1000.0,
                  "args": args}
            if r["kind"] == "event":
                ev["ph"] = "i"
                ev["s"] = "p"
            else:
                ev["ph"] = "X"
                ev["dur"] = (r["t1"] - r["t0"]) / 1000.0
                if "c0" in r:  # process CPU time: immune to time-slicing
                    ev["tdur"] = (r["c1"] - r["c0"]) / 1000.0
            out.append(ev)
        return out

    def export(self, path=None):
        """Write this process's records as one chrome-trace JSON file
        (wall-clock base). Returns the path."""
        if path is None:
            d = self._dir or os.environ.get(TRACE_DIR_ENV) or "."
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"trace.{os.getpid()}.json")
        payload = {"traceEvents": self.chrome_events(base="wall"),
                   "displayTimeUnit": "ms",
                   # per-process clock anchor, for consumers that
                   # re-base shards (requesttrace's anchor pass works
                   # off in-band origin stamps but records this for
                   # post-mortem clock forensics)
                   "clockAnchor": {"pid": os.getpid(),
                                   "wall0_ns": _WALL0,
                                   "perf0_ns": _PERF0}}
        if self.dropped:
            payload["droppedRecords"] = self.dropped
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


TRACER = Tracer()

# module-level convenience API (the spelling instrumented code uses)
span = TRACER.span
event = TRACER.event
complete_span = TRACER.complete_span
add_sink = TRACER.add_sink
clear = TRACER.clear
records = TRACER.records
export = TRACER.export
chrome_events = TRACER.chrome_events


def enable(dir=None):
    return TRACER.enable(dir=dir)


def disable():
    TRACER.disable()


def enabled():
    return TRACER.enabled


# -- cross-process merge + query helpers -------------------------------------


def load_trace(path):
    """Chrome-trace JSON file -> list of events (the traceEvents list)."""
    with open(path) as f:
        data = json.load(f)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def merge_traces(trace_dir, extra_events=()):
    """Stitch every ``trace.*.json`` under ``trace_dir`` (one per
    process of a distributed run — wall-clock base, so they align) plus
    any ``extra_events`` into one chrome-trace dict."""
    events = list(extra_events)
    if os.path.isdir(trace_dir):
        for name in sorted(os.listdir(trace_dir)):
            if name.startswith("trace.") and name.endswith(".json"):
                try:
                    events.extend(load_trace(os.path.join(trace_dir, name)))
                except (OSError, ValueError):
                    continue  # torn write from a killed process
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def spans_named(events, name):
    """Complete spans ("ph" == "X") called ``name``, sorted by ts."""
    return sorted((e for e in events
                   if e.get("ph") == "X" and e.get("name") == name),
                  key=lambda e: e["ts"])


def events_named(events, name):
    """Instant events ("ph" == "i") called ``name``, sorted by ts."""
    return sorted((e for e in events
                   if e.get("ph") == "i" and e.get("name") == name),
                  key=lambda e: e["ts"])


def span_end_us(ev):
    return ev["ts"] + ev.get("dur", 0.0)


def make_span(name, ts_us, dur_us, pid=0, tid=0, **attrs):
    """Build a chrome span dict (benchmarks synthesize derived phase
    spans — e.g. detect/restore, whose endpoints are cross-process
    facts — into the merged timeline with this)."""
    return {"name": name, "ph": "X", "pid": pid, "tid": tid,
            "cat": "paddle.span", "ts": float(ts_us),
            "dur": float(dur_us), "args": attrs}


def make_marker(name, ts_us, pid=0, tid=0, **attrs):
    return {"name": name, "ph": "i", "s": "p", "pid": pid, "tid": tid,
            "cat": "paddle.event", "ts": float(ts_us), "args": attrs}


if _truthy(os.environ.get(TRACE_ENV, "")):
    enable()
