"""paddle.profiler (counterpart: ``paddle_tpu/profiler/__init__.py``): host
annotations on the native runtime's ring, the port's control-plane spans,
and the card's kernels from CUPTI through ``torch.profiler``, exported as
one chrome trace on the host's ``perf_counter`` base.

- ``RecordEvent`` records into the native ring (``utils/native_runtime``,
  ``native/runtime/runtime.cpp``) while a ``Profiler`` runs, and into a
  Python list otherwise; the list is also where an export merges both.
- ``Profiler`` runs ``torch.profiler.profile`` with the CPU activity, and
  the CUDA activity when ``ProfilerTarget.GPU`` is among its targets (the
  default ``[CPU, GPU]``; without a card a GPU target raises). Two clocks
  are tied to the host's: at ``start()`` anchors on the profiler's host
  clock (a ``record_function`` between two ``perf_counter_ns`` reads; the
  tightest sets the offset), and at ``start()`` and ``stop()`` one each on
  the card's (a one-element fill on the idle card inside a
  ``record_function``, then a synchronize: the kernel began after the span
  did and ended before the synchronize returned, so CUPTI's placement of
  it shifts every device event onto the host clock). ``clock`` holds both
  offsets and slacks (half the window each anchor leaves, and half the
  device anchors' spread) and the launch calls whose kernel has no device
  record (``unmatched_launches``).
- ``whole`` says whether the device table holds every kernel the session
  launched; CUPTI loses records (on an H100, a session's first launches,
  most often late in a long process), and ``summary()`` says so.
- The device op table (``device_ops``: kernel name -> [calls, seconds]) is
  built after the run from the device events themselves, the raw CUPTI
  records of ``kineto_results.events()``. It adds no per-op
  synchronisation and does not go through ``key_averages()``.
- ``serialize=True`` installs ``ops.dispatch``'s hook, which times each
  dispatched op and synchronises on its outputs: framework op names, but
  serialized execution. ``stop()`` removes it.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from enum import Enum

import torch

from ..utils import native_runtime as _native


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(closed=0, ready=0, record=0, repeat=0, skip_first=0):
    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        total = closed + ready + record
        pos = s % total if total else 0
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == total - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return scheduler


_events = []
_events_lock = threading.Lock()
_ANCHOR = "paddle.profiler.anchor"
_DEVICE_ANCHOR = "paddle.profiler.device_anchor"
_ANCHORS = 3


class RecordEvent:
    """User annotation; a complete event on the host track of the export.

    While a ``Profiler`` records, the span goes to the native ring (one C
    call on exit); otherwise to the Python list, which is also where an
    export merges both."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._t0 = None

    def begin(self):
        self.__enter__()

    def end(self):
        self.__exit__()

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if _native.trace_enabled():
            _native.record(self.name, self._t0, t1)
            return False
        with _events_lock:
            _events.append({"name": self.name, "ph": "X", "pid": os.getpid(),
                            "tid": threading.get_ident(),
                            "ts": self._t0 / 1000.0,
                            "dur": (t1 - self._t0) / 1000.0})
        return False


def _all_host_events():
    """Python-recorded events + native-recorded events, one schema."""
    with _events_lock:
        out = list(_events)
    pid = os.getpid()
    for name, tid, t0, t1 in _native.events_snapshot():
        out.append({"name": name, "ph": "X", "pid": pid, "tid": tid,
                    "ts": t0 / 1000.0, "dur": (t1 - t0) / 1000.0})
    return out


def _observability_events():
    """The port's control-plane spans (``observability.trace``) on the
    same perf_counter base as the host events."""
    from ..observability import trace as _obs_trace
    return _obs_trace.chrome_events(base="perf")


def _device_anchor():
    """One small kernel on the idle card inside a ``_DEVICE_ANCHOR`` span;
    the ``perf_counter_ns`` read after the synchronize that waits for it."""
    buf = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with torch.profiler.record_function(_DEVICE_ANCHOR):
        buf.fill_(1.0)
    torch.cuda.synchronize()
    return time.perf_counter_ns()


def _annotation(e):
    """A ``record_function`` span, on the host track or as kineto mirrors
    it on the device track around the kernels it launched: no device work
    of its own."""
    flag = getattr(e, "is_user_annotation", None)
    return e.name() in (_ANCHOR, _DEVICE_ANCHOR) or bool(flag and flag())


def _device_events(kineto_results, anchors, device_anchors=()):
    """(chrome events of the card's kernels, memsets and copies on the
    perf_counter base, clock {"offset_ns", "slack_us", "device_offset_us",
    "device_offsets_us", "device_windows_us", "device_slack_us",
    "placement_slack_us", "host_events", "launch_calls",
    "unmatched_launches", "unmatched_by_call", "unmatched_at_ms",
    "last_launch_ms"}: the
    alignment of both clocks, how many host events and launch calls the
    trace holds beside the device events, and how many of those launches
    have no device record, in all and by the launch call's name, with the
    first and last such launch and the last launch of all in ms after the
    session's first anchor: records CUPTI lost, which makes the device
    table short). Each event's args carry its correlation id and, where
    the host's launch call is in the trace, ``launch_delay_us``: the
    kernel's aligned start less the call's.

    ``anchors`` are (t0_ns, t1_ns) perf_counter reads around each anchor
    ``record_function``; the tightest pair sets the offset between the
    profiler's host clock and perf_counter, to within its slack.
    ``device_anchors`` are the perf_counter reads after each
    ``_device_anchor``'s synchronize (one at ``start()``, one at
    ``stop()``): each anchor's kernel ran inside [its span's start, that
    read less its duration] on the host clock, so that window less CUPTI's
    start of the kernel holds the shift from CUPTI's clock to the host's
    (``device_offsets_us``: each window's middle; ``device_windows_us``:
    its half width). Every device event moves by the middle of the shifts
    all windows share (``device_offset_us``), to within half their width
    (``device_slack_us``); where they share none (CUPTI's clock moved
    during the session), by the mean of the middles, to within the widest
    half window plus half the middles' spread. CUPTI's clock also moves
    between the anchors (on an H100, by 0.1 to 0.4 ms within a 0.4 s
    session), so ``placement_slack_us`` is the larger of that slack and
    how far the earliest kernel lies before its own launch call: how far
    a device event may be from where it ran, as far as the trace shows. An anchor whose kernel has no record (CUPTI loses
    a session's first records late in a long process) is left out; both
    None when neither has one. The anchors' kernels and the device
    track's ``record_function`` spans are in neither the events nor the
    counts."""
    events = kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    marks = sorted((e for e in events if e.name() == _ANCHOR
                    and e.device_type() != cuda), key=lambda e: e.start_ns())
    if len(marks) != len(anchors):
        raise RuntimeError(f"profiler: {len(marks)} clock anchors in the "
                           f"trace, {len(anchors)} recorded")
    best = None
    for (t0, t1), m in zip(anchors, marks):
        slack = (t1 - t0) - m.duration_ns()
        offset = (t0 + t1) // 2 - (m.start_ns() + m.duration_ns() // 2)
        if best is None or slack < best[1]:
            best = (offset, slack)
    offset, slack = best
    # the host's launch call of each device event, by correlation id (a
    # host function launched into a stream runs no device work)
    launched = {e.correlation_id(): (e.start_ns(), e.name())
                for e in events
                if e.device_type() != cuda and e.correlation_id()
                and "Launch" in e.name() and "HostFunc" not in e.name()}
    # the device anchors: each one's launch call inside its span (else,
    # should CUPTI's host records run on another clock than the spans',
    # the session's first launch for the start's and its last for the
    # stop's), and the kernel of that call
    fits, anchor_ids = [], set()
    spans = sorted((e for e in events if e.name() == _DEVICE_ANCHOR
                    and e.device_type() != cuda), key=lambda e: e.start_ns())
    if len(spans) != len(device_anchors):
        raise RuntimeError(f"profiler: {len(spans)} device anchors in the "
                           f"trace, {len(device_anchors)} recorded")
    by_time = sorted(launched, key=lambda c: launched[c][0])
    for i, (span, t1) in enumerate(zip(spans, device_anchors)):
        lo = span.start_ns()
        ids = {c for c, (t, _) in launched.items()
               if lo <= t <= lo + span.duration_ns()}
        if not ids and by_time:
            ids = {by_time[0] if i == 0 else by_time[-1]}
        anchor_ids |= ids
        for k in events:
            if k.device_type() == cuda and k.correlation_id() in ids \
                    and not _annotation(k):
                hi = max(t1 - offset - k.duration_ns(), lo)
                fits.append((lo - k.start_ns(), hi - k.start_ns()))
                break
    for c in anchor_ids:
        del launched[c]
    shift, device_slack = 0, None
    if fits:
        # the shifts every anchor allows; where none is common to all (the
        # clock moved), the mean of their middles, the spread in the slack
        lo, hi = max(a for a, _ in fits), min(b for _, b in fits)
        mids = [(a + b) / 2 for a, b in fits]
        if lo <= hi:
            shift, device_slack = (lo + hi) // 2, (hi - lo) / 2000.0
        else:
            shift = int(sum(mids) / len(mids))
            device_slack = (max(b - a for a, b in fits) / 2
                            + (max(mids) - min(mids)) / 2) / 1000.0
    recorded = set()
    out = []
    for e in events:
        if e.device_type() != cuda or e.correlation_id() in anchor_ids \
                or _annotation(e):
            continue
        start = e.start_ns() + shift
        args = {"correlation": e.correlation_id()}
        recorded.add(e.correlation_id())
        if e.correlation_id() in launched:
            args["launch_delay_us"] = (
                start - launched[e.correlation_id()][0]) / 1000.0
        out.append({"name": e.name(), "ph": "X",
                    "pid": f"cuda:{e.device_index()}",
                    "tid": f"stream {e.device_resource_id()}",
                    "cat": str(e.activity_type())
                    if hasattr(e, "activity_type") else "device",
                    "ts": (start + offset) / 1000.0,
                    "dur": e.duration_ns() / 1000.0, "args": args})
    out.sort(key=lambda ev: ev["ts"])
    # no kernel starts before its launch call: one placed earlier shows the
    # device clock off by at least that much where it ran
    early = min((ev["args"]["launch_delay_us"] for ev in out
                 if "launch_delay_us" in ev["args"]), default=0.0)
    unmatched, lost_at = {}, []
    for c in launched.keys() - recorded:
        t, name = launched[c]
        unmatched[name] = unmatched.get(name, 0) + 1
        lost_at.append((t - marks[0].start_ns()) / 1e6)
    return out, {"offset_ns": offset, "slack_us": max(slack, 0) / 2000.0,
                 "device_offset_us": shift / 1000.0 if fits else None,
                 "device_offsets_us": [(a + b) / 2000.0 for a, b in fits],
                 "device_windows_us": [(b - a) / 2000.0 for a, b in fits],
                 "device_slack_us": device_slack,
                 "placement_slack_us": max(device_slack or 0.0, -early),
                 "host_events": len(events) - len(out),
                 "launch_calls": len(launched),
                 "unmatched_launches": len(lost_at),
                 "unmatched_by_call": unmatched,
                 "unmatched_at_ms": [min(lost_at), max(lost_at)]
                 if lost_at else None,
                 "last_launch_ms": (max(t for t, _ in launched.values())
                                    - marks[0].start_ns()) / 1e6
                 if launched else None}


def _device_op_table(device_events):
    """{kernel name: [calls, total seconds]} from the device events."""
    table = {}
    for e in device_events:
        row = table.setdefault(e["name"], [0, 0.0])
        row[0] += 1
        row[1] += e["dur"] / 1e6
    return table


def export_chrome_tracing(dir_name, worker_name=None):
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        fname = os.path.join(dir_name,
                             f"{worker_name or 'worker'}_trace.json")
        events = _all_host_events()
        events += _observability_events()
        events += getattr(prof, "device_events", [])
        with open(fname, "w") as f:
            json.dump({"traceEvents": events}, f)
        return fname
    return handler


def export_protobuf(dir_name, worker_name=None):
    return export_chrome_tracing(dir_name, worker_name)


class Profiler:
    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 record_shapes=False, profile_memory=False, timer_only=False,
                 serialize=False, **kwargs):
        self.targets = list(targets or [ProfilerTarget.CPU,
                                        ProfilerTarget.GPU])
        unknown = [t for t in self.targets
                   if t not in (ProfilerTarget.CPU, ProfilerTarget.GPU)]
        if unknown:
            raise ValueError(f"profiler: the port traces the CPU and the "
                             f"CUDA card only, not {unknown}")
        if ProfilerTarget.GPU in self.targets and \
                not torch.cuda.is_available():
            raise RuntimeError(
                "profiler: ProfilerTarget.GPU needs a CUDA card and none is "
                "available; pass targets=[ProfilerTarget.CPU] to profile the "
                "host alone")
        self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.timer_only = timer_only
        # serialize=True: additionally time each dispatched op by
        # synchronising on its outputs: framework-level names, but
        # serialized execution (the observer effect the device table
        # avoids); opt-in only
        self.serialize = serialize
        self._step = 0
        self._prof = None
        self._anchors, self._device_anchors = [], []
        self.device_events = []
        self.device_ops = {}
        self.clock = None

    def start(self):
        _events.clear()
        _native.trace_start()
        self._op_events = {}
        self.device_events, self.device_ops, self.clock = [], {}, None
        if not self.timer_only:
            if ProfilerTarget.GPU in self.targets:
                # the anchors' kernel loaded before the session, so that
                # loading it does not widen the first anchor's window
                torch.empty(1, device="cuda").fill_(1.0)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if ProfilerTarget.GPU in self.targets:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts, record_shapes=self.record_shapes,
                profile_memory=self.profile_memory)
            self._prof.start()
            self._anchors = []
            for _ in range(_ANCHORS):
                t0 = time.perf_counter_ns()
                with torch.profiler.record_function(_ANCHOR):
                    pass
                self._anchors.append((t0, time.perf_counter_ns()))
            self._device_anchors = [_device_anchor()] \
                if ProfilerTarget.GPU in self.targets else []
            if self.serialize:
                from ..ops import dispatch as _dispatch

                def _rec(name, dur, agg=self._op_events):
                    e = agg.setdefault(name, [0, 0.0])
                    e[0] += 1
                    e[1] += dur
                _dispatch.set_op_profiler(_rec)
        self._t0 = time.perf_counter()

    def stop(self):
        from ..ops import dispatch as _dispatch
        _dispatch.set_op_profiler(None)
        _native.trace_stop()
        if self._prof is not None:
            prof, self._prof = self._prof, None
            if ProfilerTarget.GPU in self.targets:
                self._device_anchors.append(_device_anchor())
            prof.stop()
            # the device table from the kernels' own records, after the
            # run: no per-op synchronisation happened during it
            self.device_events, self.clock = _device_events(
                prof.profiler.kineto_results, self._anchors,
                self._device_anchors)
            self.device_ops = _device_op_table(self.device_events)
        if self.on_trace_ready:
            self.on_trace_ready(self)

    @property
    def whole(self):
        """Whether every kernel launch call of the last session has its
        device record, so that ``device_ops`` holds every kernel the
        session launched (False before a traced session has stopped)."""
        return self.clock is not None and \
            not self.clock["unmatched_launches"]

    def step(self, num_samples=None):
        self._step += 1

    def step_info(self, unit=None):
        dt = time.perf_counter() - self._t0
        return f"step {self._step}: {dt:.4f}s elapsed"

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        by_name = {}
        for e in _all_host_events():
            agg = by_name.setdefault(e["name"], {"calls": 0, "total": 0.0})
            agg["calls"] += 1
            agg["total"] += e["dur"] / 1000.0
        lines = ["---- Host Event Summary ----",
                 f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}"]
        for name, agg in sorted(by_name.items(),
                                key=lambda kv: -kv[1]["total"]):
            lines.append(f"{name:<40}{agg['calls']:>8}{agg['total']:>12.3f}")

        if op_detail and self.clock is not None and \
                ProfilerTarget.GPU in self.targets:
            c = self.clock
            state = (f"whole: each of {c['launch_calls']} launch calls has "
                     f"its device record") if self.whole else (
                f"SHORT: {c['unmatched_launches']} of {c['launch_calls']} "
                f"launch calls have no device record (CUPTI lost them); "
                f"the rows below miss their kernels")
            lines += ["", "---- Device Op Summary (CUPTI, no per-op "
                      "sync) ----", state,
                      f"{'Op':<40}{'Calls':>8}{'Total(ms)':>12}"
                      f"{'Avg(us)':>12}"]
            for name, (calls, total) in sorted(self.device_ops.items(),
                                               key=lambda kv: -kv[1][1]):
                lines.append(f"{name[:40]:<40}{calls:>8}"
                             f"{total * 1e3:>12.3f}"
                             f"{total / calls * 1e6:>12.1f}")

        op_events = getattr(self, "_op_events", None)
        if op_detail and op_events:
            lines += ["", "---- Serialized Op Summary (opt-in "
                      "serialize=True; measures serialized exec) ----",
                      f"{'Op':<40}{'Calls':>8}{'Total(ms)':>12}"
                      f"{'Avg(us)':>12}"]
            for name, (calls, total) in sorted(op_events.items(),
                                               key=lambda kv: -kv[1][1]):
                lines.append(f"{name:<40}{calls:>8}{total * 1e3:>12.3f}"
                             f"{total / calls * 1e6:>12.1f}")

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
            if stats:
                lines += ["", "---- Device Memory ----"]
                for k, v in sorted(stats.items()):
                    lines.append(f"{k:<40}{v:>20}")
        report = "\n".join(lines)
        print(report)
        return report

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


@contextlib.contextmanager
def profiler(targets=None, **kwargs):
    p = Profiler(targets=targets, **kwargs)
    p.start()
    try:
        yield p
    finally:
        p.stop()


def load_profiler_result(file_name):
    with open(file_name) as f:
        return json.load(f)
