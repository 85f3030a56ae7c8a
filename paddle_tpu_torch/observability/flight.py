"""Flight recorder: a bounded ring of the most recent spans/events per
process, dumped to a file when the process is about to die (a copy of
``paddle_tpu/observability/flight.py``).

The trace buffer answers "what happened?" only if the process lives to
export it; chaos kills are exactly the case where it does not. The ring
here is cheap enough to stay on (append to a deque), capacity-bounded
(``PADDLE_FLIGHT_CAPACITY``, default 4096 records), and dumped:

- explicitly (``dump(reason=...)`` — the launcher calls this on the
  SIGTERM/SIGKILL teardown-escalation path, so every chaos-test failure
  leaves an artifact);
- on SIGTERM via ``install_signal_dump()`` (previous disposition is
  captured and CHAINED — the signal-handler-hygiene
  contract: a preemption-checkpoint handler installed before us still
  runs, and a default disposition still terminates);
- on an unhandled exception via ``install_excepthook()``.

SIGKILL cannot be caught by design: for that case the SUPERVISOR (the
elastic agent's launcher, which chose to escalate) dumps ITS ring,
which holds the detect/teardown story for the dying rank.

Enabled whenever tracing is (``PADDLE_TRACE``) or independently via
``PADDLE_FLIGHT``; dumps land in ``PADDLE_FLIGHT_DIR`` (default: the
trace dir, then the system temp dir). Pure stdlib, standalone-importable
(same constraint as trace.py).
"""
from __future__ import annotations

import collections
import json
import os
import signal
import sys
import tempfile
import time

FLIGHT_ENV = "PADDLE_FLIGHT"
FLIGHT_DIR_ENV = "PADDLE_FLIGHT_DIR"
CAPACITY_ENV = "PADDLE_FLIGHT_CAPACITY"
_TRACE_ENV = "PADDLE_TRACE"          # mirrors trace.py (no cross-import:
_TRACE_DIR_ENV = "PADDLE_TRACE_DIR"  # both must load standalone)

DEFAULT_CAPACITY = 4096


def _truthy(v):
    return str(v).strip().lower() not in ("", "0", "false", "off", "no")


def _env_capacity():
    try:
        return int(os.environ.get(CAPACITY_ENV, DEFAULT_CAPACITY))
    except ValueError:
        return DEFAULT_CAPACITY


class FlightRecorder:
    def __init__(self, capacity=None):
        self.capacity = capacity or _env_capacity()
        # NO lock by design: record/trace_sink rely on deque.append
        # being atomic, and snapshot() runs inside signal handlers
        # where taking a lock the interrupted thread might hold would
        # self-deadlock (see snapshot's retry instead)
        self._ring = collections.deque(maxlen=self.capacity)
        self._dump_seq = 0
        self.enabled = _truthy(os.environ.get(FLIGHT_ENV, "")) or \
            _truthy(os.environ.get(_TRACE_ENV, ""))
        self.last_dump_path = None

    # -- recording -----------------------------------------------------------
    def record(self, kind, name, **data):
        """Append one record; disabled cost is one attribute check."""
        if not self.enabled:
            return
        self._ring.append({"ts_ns": time.time_ns(), "kind": kind,
                           "name": name, "data": data})

    def trace_sink(self, rec):
        """trace.Tracer sink: completed spans/events feed the ring (the
        package __init__ wires this up)."""
        if not self.enabled:
            return
        self._ring.append({
            "ts_ns": time.time_ns(), "kind": rec["kind"],
            "name": rec["name"],
            "data": dict(rec["attrs"], span_id=rec["span_id"],
                         dur_ms=(rec["t1"] - rec["t0"]) / 1e6)})

    def snapshot(self):
        """Ring contents, oldest first. Lock-free on purpose: this runs
        inside signal handlers, where taking the recording lock could
        self-deadlock against the interrupted thread; a concurrent
        append during list() is retried once, then best-effort."""
        for _ in range(3):
            try:
                return list(self._ring)
            except RuntimeError:
                continue
        return []  # mutation storm: an empty dump beats a crash here

    def clear(self):
        self._ring.clear()
        self.last_dump_path = None

    # -- dumping -------------------------------------------------------------
    def _dump_dir(self):
        return (os.environ.get(FLIGHT_DIR_ENV)
                or os.environ.get(_TRACE_DIR_ENV)
                or tempfile.gettempdir())

    def dump(self, path=None, reason="", **meta):
        """Write the ring to a JSON artifact; returns the path (None if
        the recorder is disabled — a dump of nothing helps nobody)."""
        if not self.enabled:
            return None
        if path is None:
            d = self._dump_dir()
            os.makedirs(d, exist_ok=True)
            self._dump_seq += 1
            path = os.path.join(
                d, f"flight.{os.getpid()}.{self._dump_seq}.json")
        payload = {"artifact": "flight_recorder", "pid": os.getpid(),
                   "reason": reason, "meta": meta,
                   "dumped_at_ns": time.time_ns(),
                   "capacity": self.capacity,
                   "events": self.snapshot()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        self.last_dump_path = path
        return path

    # -- crash hooks ---------------------------------------------------------
    def install_signal_dump(self, signums=(signal.SIGTERM, signal.SIGINT)):
        """Dump the ring when any of ``signums`` arrives, then CHAIN to
        the previous disposition (a captured handler runs; SIG_DFL is
        re-delivered so the signal still terminates). SIGINT is in the
        default set: a Ctrl-C'd run leaves the same
        artifact a killed one does — python's default SIGINT handler is
        the chained previous disposition, so KeyboardInterrupt still
        raises in the interrupted frame after the dump. Returns a
        ``restore()`` callable re-installing the previous handlers."""
        prev = {}

        def _handler(signum, frame):
            try:
                self.dump(reason=f"signal {signum}")
            # crash-path best effort: a failed dump must not mask the signal's
            # real disposition below
            except Exception:
                pass
            p = prev.get(signum)
            if callable(p):
                p(signum, frame)
                return
            # restore the previous (default/ignore) disposition and
            # re-deliver so kill semantics are preserved —
            # double-SIGTERM lesson, applied proactively
            signal.signal(signum, p if p is not None else signal.SIG_DFL)
            if p != signal.SIG_IGN:
                os.kill(os.getpid(), signum)

        for s in signums:
            prev[s] = signal.signal(s, _handler)

        def restore():
            for s, prev_h in prev.items():
                signal.signal(s, prev_h)

        return restore

    def install_excepthook(self):
        """Dump on an unhandled exception, then run the previous hook."""
        prev_hook = sys.excepthook

        def _hook(exc_type, exc, tb):
            try:
                self.dump(reason=f"unhandled {exc_type.__name__}: {exc}")
            # crash-path best effort: the original traceback (printed by the
            # chained hook) is the primary artifact
            except Exception:
                pass
            prev_hook(exc_type, exc, tb)

        sys.excepthook = _hook

        def restore():
            sys.excepthook = prev_hook

        return restore


RECORDER = FlightRecorder()

record = RECORDER.record
dump = RECORDER.dump
snapshot = RECORDER.snapshot
clear = RECORDER.clear
install_signal_dump = RECORDER.install_signal_dump
install_excepthook = RECORDER.install_excepthook


def enable():
    RECORDER.enabled = True


def disable():
    RECORDER.enabled = False


def enabled():
    return RECORDER.enabled


def load_dump(path):
    with open(path) as f:
        return json.load(f)
