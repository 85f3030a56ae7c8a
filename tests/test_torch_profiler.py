"""``paddle_tpu_torch.profiler`` and the native runtime it records into,
held to the reference's (``paddle_tpu.profiler``,
``paddle_tpu.utils.native_runtime``) on the same inputs, on the CPU:

- ``make_scheduler``'s states for steps 0 to 63 over a grid of its
  arguments;
- one ``RecordEvent`` sequence with control-plane spans: the same
  ``(name, ph)`` multiset in both chrome exports (host events from the
  native ring, spans on the perf base) and the same host-summary rows by
  name and calls; the port also with its ``torch.profiler`` session on
  (``targets=[ProfilerTarget.CPU]``), whose clock anchors align it;
- ``serialize=True`` installs ``ops.dispatch``'s hook (framework op names
  in the summary) and ``stop()`` removes it; without it the hook stays
  None (the reference's ``tests/test_flags_and_dp.py`` case, mirrored);
- a GPU target without a card raises, naming ``ProfilerTarget.CPU``;
- the device events of a scripted trace land on the host clock through
  the device anchors at both ends of the session, with the slack their
  windows and spread give, and without the anchors' kernels; a launch
  without its kernel's record makes ``whole`` false and ``summary()``
  say the device table is short;
- ``NativeBlockingQueue`` in both packages: FIFO, ``queue.Empty`` and
  ``queue.Full`` on timeout, ``ValueError`` after close, a close that
  wakes a blocked ``get``; the two libraries' rings are independent;
- the threaded ``DataLoader`` (now on the native queue) yields the
  batches of the single-process loader and of the reference's, in order.
"""
import collections
import itertools
import json
import queue
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.profiler as jprof
import paddle_tpu.utils.native_runtime as jnative
from paddle_tpu.io import DataLoader as JDataLoader
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.observability import trace as jtrace
import paddle_tpu_torch as paddle
import paddle_tpu_torch.profiler as pprof
from paddle_tpu_torch.io import DataLoader, TensorDataset
from paddle_tpu_torch.observability import trace as ptrace
from paddle_tpu_torch.ops import dispatch as pdispatch
from paddle_tpu_torch.utils import native_runtime as pnative

GRID = list(itertools.product((0, 1, 2), (0, 1), (0, 1, 3), (0, 2),
                              (0, 1, 5)))


@pytest.mark.parametrize("closed,ready,record,repeat,skip_first", GRID)
def test_make_scheduler_states_equal_the_reference(closed, ready, record,
                                                   repeat, skip_first):
    kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
              skip_first=skip_first)
    port, ref = pprof.make_scheduler(**kw), jprof.make_scheduler(**kw)
    assert [port(s).name for s in range(64)] == \
        [ref(s).name for s in range(64)]


def _recorded_run(prof_mod, trace_mod, make, tmp, name):
    """Three steps of RecordEvents with a trace span each, under a profiler
    made by ``make``, exported to ``tmp``; (events, summary rows)."""
    trace_mod.clear()
    trace_mod.enable()
    try:
        p = make(prof_mod.export_chrome_tracing(str(tmp), name))
        p.start()
        for i in range(3):
            with prof_mod.RecordEvent("train_step"):
                with trace_mod.span("fetch", step=i):
                    pass
                with prof_mod.RecordEvent("forward"):
                    pass
            p.step()
        with prof_mod.RecordEvent("eval"):
            pass
        p.stop()
        report = p.summary()
    finally:
        trace_mod.disable()
        trace_mod.clear()
    with open(tmp / f"{name}_trace.json") as f:
        events = json.load(f)["traceEvents"]
    host = report.split("---- Host Event Summary ----")[1].split("\n\n")[0]
    rows = {ln.split()[0]: int(ln.split()[1])
            for ln in host.strip().splitlines()[1:]}
    return events, rows


@pytest.mark.parametrize("port_session", ["timer_only", "cpu_trace"])
def test_chrome_export_and_summary_equal_the_reference(tmp_path,
                                                       port_session):
    ref_events, ref_rows = _recorded_run(
        jprof, jtrace, lambda ready: jprof.Profiler(
            timer_only=True, on_trace_ready=ready), tmp_path, "jax")
    if port_session == "timer_only":
        def make(ready):
            return pprof.Profiler(targets=[pprof.ProfilerTarget.CPU],
                                  timer_only=True, on_trace_ready=ready)
    else:
        def make(ready):
            return pprof.Profiler(targets=[pprof.ProfilerTarget.CPU],
                                  on_trace_ready=ready)
    port_events, port_rows = _recorded_run(pprof, ptrace, make, tmp_path,
                                           "torch")
    def key(evs):
        return collections.Counter((e["name"], e["ph"]) for e in evs)
    assert key(port_events) == key(ref_events)
    assert key(port_events)[("train_step", "X")] == 3
    assert port_rows == ref_rows == {"train_step": 3, "forward": 3,
                                     "eval": 1}
    # one timeline: every event on the perf_counter base, inside the run
    now_us = time.perf_counter_ns() / 1e3
    assert all(0 < e["ts"] <= now_us for e in port_events)
    steps = sorted((e for e in port_events if e["name"] == "train_step"),
                   key=lambda e: e["ts"])
    fetch = sorted((e for e in port_events if e["name"] == "fetch"),
                   key=lambda e: e["ts"])
    for s, f in zip(steps, fetch):
        assert s["ts"] <= f["ts"] and \
            f["ts"] + f["dur"] <= s["ts"] + s["dur"]


def test_cpu_session_aligns_its_clock():
    p = pprof.Profiler(targets=[pprof.ProfilerTarget.CPU])
    p.start()
    torch.ones(64, 64) @ torch.ones(64, 64)
    p.stop()
    assert p.device_ops == {} and p.device_events == []
    assert 0 <= p.clock["slack_us"] < 5e4


class _Event:
    """A kineto event as ``_device_events`` reads it (times in ns)."""

    def __init__(self, name, start, dur, corr=0, cuda=False,
                 annotation=False):
        self._v = (name, start, dur, corr, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[4] else \
            torch.autograd.DeviceType.CPU

    def device_index(self):
        return 0

    def is_user_annotation(self):
        return self._v[5]

    def device_resource_id(self):
        return 7


class _Trace:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


PERF_OFFSET = 10 ** 12    # perf_counter_ns less the profiler's host clock


def _two_clock_trace(skews, launch_lag=0, lost_start=False,
                     sync_back=(4000, 4000)):
    """A session on a card whose CUPTI clock reads ``skews`` ns behind the
    host's at the start and at the stop device anchor: three host
    anchors; a device anchor (launch 500 ns into its span, kernel 1,000 ns
    in for 2,000 ns, synchronize back 4,000 ns in) at each end; a
    ``flash_fwd_kernel`` 5,000 ns after its launch call, a launch whose
    kernel has no record, and a copy; kineto's device-track copy of each
    anchor span that kept its kernel. ``launch_lag`` moves every launch
    call's record later (a runtime clock apart from the spans');
    ``lost_start`` drops the start anchor's kernel record; ``sync_back``
    is when each anchor's synchronize returns. (trace, host anchors,
    device anchors)."""
    ev, anchors, device = [], [], []
    for t in (1000, 2000, 3000):
        ev.append(_Event(pprof._ANCHOR, t, 100))
        anchors.append((t + PERF_OFFSET - 10, t + 100 + PERF_OFFSET + 10))
    for (t, corr), skew, back in zip(((5000, 1), (100000, 9)), skews,
                                     sync_back):
        ev += [_Event(pprof._DEVICE_ANCHOR, t, 3000, annotation=True),
               _Event("cudaLaunchKernel", t + 500 + launch_lag, 50, corr)]
        if not (lost_start and corr == 1):
            ev += [_Event("fill", t + 1000 - skew, 2000, corr, cuda=True),
                   _Event(pprof._DEVICE_ANCHOR, t + 1000 - skew, 2000, corr,
                          cuda=True, annotation=True)]
        device.append(t + back + PERF_OFFSET)
    ev += [_Event("cudaLaunchKernel", 20000 + launch_lag, 50, 2),
           _Event("flash_fwd_kernel", 25000 - skews[0], 4000, 2, cuda=True),
           _Event("cudaLaunchKernel", 30000 + launch_lag, 50, 3),
           _Event("Memcpy HtoD", 40000 - skews[0], 1000, 4, cuda=True)]
    return _Trace(ev), anchors, device


def test_device_events_on_the_host_clock_by_both_anchors():
    skew = 1_270_000
    trace, anchors, device = _two_clock_trace((skew, skew))
    events, clock = pprof._device_events(trace, anchors, device)
    assert [e["name"] for e in events] == ["flash_fwd_kernel", "Memcpy HtoD"]
    k2 = events[0]
    assert k2["ts"] == (25000 + PERF_OFFSET) / 1000.0
    assert k2["args"]["launch_delay_us"] == 5.0
    assert clock["offset_ns"] == PERF_OFFSET
    assert clock["device_offsets_us"] == [skew / 1000.0] * 2
    assert clock["device_windows_us"] == [1.0, 1.0]
    assert clock["device_offset_us"] == skew / 1000.0
    assert clock["device_slack_us"] == clock["placement_slack_us"] == 1.0
    assert clock["launch_calls"] == 2 and clock["unmatched_launches"] == 1
    assert pprof._device_op_table(events)["flash_fwd_kernel"] == [1, 4e-6]


def test_the_narrower_anchor_window_sets_the_shift():
    skew = 120_000
    trace, anchors, device = _two_clock_trace((skew, skew),
                                              sync_back=(4000, 400_000))
    events, clock = pprof._device_events(trace, anchors, device)
    assert clock["device_windows_us"] == [1.0, 199.0]
    assert clock["device_offsets_us"] == [120.0, 318.0]
    assert clock["device_offset_us"] == 120.0
    assert clock["device_slack_us"] == 1.0
    assert events[0]["ts"] == (25000 + PERF_OFFSET) / 1000.0


def test_a_moving_device_clock_widens_the_slack():
    trace, anchors, device = _two_clock_trace((0, 400_000))
    events, clock = pprof._device_events(trace, anchors, device)
    assert clock["device_offsets_us"] == [0.0, 400.0]
    assert clock["device_offset_us"] == 200.0
    assert clock["device_slack_us"] == 1.0 + 200.0
    # the flash kernel, placed at the start anchor's reading, moves by the
    # mean shift: within the slack of where it ran
    assert abs(events[0]["ts"] - (25000 + PERF_OFFSET) / 1000.0) <= \
        clock["device_slack_us"]


def test_device_anchors_found_by_order_when_launch_records_lag():
    skew = 1_270_000
    trace, anchors, device = _two_clock_trace((skew, skew),
                                              launch_lag=700_000)
    events, clock = pprof._device_events(trace, anchors, device)
    assert clock["device_offsets_us"] == [skew / 1000.0] * 2
    assert [e["name"] for e in events] == ["flash_fwd_kernel", "Memcpy HtoD"]
    assert events[0]["ts"] == (25000 + PERF_OFFSET) / 1000.0
    # the lag shows as a kernel before its launch call, and the placement
    # slack takes it in
    assert events[0]["args"]["launch_delay_us"] == 5.0 - 700.0
    assert clock["placement_slack_us"] == 695.0
    assert clock["launch_calls"] == 2 and clock["unmatched_launches"] == 1


def test_a_lost_start_anchor_leaves_the_stop_anchor():
    skew = 30_000
    trace, anchors, device = _two_clock_trace((skew, skew), lost_start=True)
    events, clock = pprof._device_events(trace, anchors, device)
    assert clock["device_offsets_us"] == [skew / 1000.0]
    assert clock["device_slack_us"] == 1.0
    assert [e["name"] for e in events] == ["flash_fwd_kernel", "Memcpy HtoD"]
    assert clock["launch_calls"] == 2 and clock["unmatched_launches"] == 1


def test_summary_says_when_the_device_table_is_short():
    p = pprof.Profiler(targets=[pprof.ProfilerTarget.CPU])
    assert not p.whole                  # no session yet
    p.targets.append(pprof.ProfilerTarget.GPU)
    trace, anchors, device = _two_clock_trace((0, 0))
    p.device_events, p.clock = pprof._device_events(trace, anchors, device)
    p.device_ops = pprof._device_op_table(p.device_events)
    assert not p.whole
    report = p.summary()
    assert "SHORT: 1 of 2 launch calls have no device record" in report
    p.clock["unmatched_launches"] = 0
    assert p.whole
    assert "whole: each of 2 launch calls" in p.summary()


def test_anchor_counts_must_match_the_trace():
    trace, anchors, device = _two_clock_trace((0, 0))
    with pytest.raises(RuntimeError, match="device anchors"):
        pprof._device_events(trace, anchors, device[:1])


def test_serialized_op_table_is_opt_in():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    try:
        assert pdispatch._op_profiler is None
        p = pprof.Profiler(targets=[pprof.ProfilerTarget.CPU])
        p.start()
        assert pdispatch._op_profiler is None   # no per-op sync installed
        p.stop()
        p = pprof.Profiler(targets=[pprof.ProfilerTarget.CPU],
                           serialize=True)
        p.start()
        assert pdispatch._op_profiler is not None
        a = paddle.to_tensor(np.random.default_rng(0).random(
            (32, 32)).astype("float32"))
        for _ in range(3):
            paddle.matmul(a, a)
        paddle.exp(a)
        p.stop()
        report = p.summary()
    finally:
        paddle.set_device(prev)
    assert pdispatch._op_profiler is None
    assert "Serialized Op Summary" in report
    assert "matmul" in report and "exp" in report
    assert p._op_events["matmul"][0] == 3


def test_gpu_target_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for targets in (None, [pprof.ProfilerTarget.GPU],
                    [pprof.ProfilerTarget.CPU, pprof.ProfilerTarget.GPU]):
        with pytest.raises(RuntimeError,
                           match=r"targets=\[ProfilerTarget\.CPU\]"):
            pprof.Profiler(targets=targets)
    with pytest.raises(RuntimeError, match="ProfilerTarget.CPU"):
        with pprof.profiler():
            pass
    with pytest.raises(ValueError, match="TPU"):
        pprof.Profiler(targets=[pprof.ProfilerTarget.TPU])


@pytest.fixture(params=["torch", "jax"])
def native(request):
    return pnative if request.param == "torch" else jnative


def test_native_queue_fifo_and_timeouts(native):
    q = native.NativeBlockingQueue(2)
    q.put("a")
    q.put({"b": 1})
    assert q.qsize() == 2
    t0 = time.monotonic()
    with pytest.raises(queue.Full):
        q.put("c", timeout=0.2)
    assert 0.15 < time.monotonic() - t0 < 2.0
    assert q.get() == "a" and q.get() == {"b": 1}
    t0 = time.monotonic()
    with pytest.raises(queue.Empty):
        q.get(timeout=0.2)
    assert 0.15 < time.monotonic() - t0 < 2.0
    q.put(3)
    q.close()
    with pytest.raises(ValueError):
        q.put(4)
    assert q.get() == 3        # a closed queue still drains
    with pytest.raises(ValueError):
        q.get(timeout=0.1)


def test_native_queue_close_wakes_a_blocked_get(native):
    q = native.NativeBlockingQueue(0)
    got = []

    def consumer():
        try:
            q.get()
        except ValueError as e:
            got.append(e)

    th = threading.Thread(target=consumer)
    th.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    q.close()
    th.join(timeout=5)
    assert not th.is_alive() and len(got) == 1
    assert time.monotonic() - t0 < 1.0


def test_native_queue_many_producers():
    q = pnative.NativeBlockingQueue(4)
    n, per = 8, 200

    def produce(w):
        for i in range(per):
            q.put((w, i))

    threads = [threading.Thread(target=produce, args=(w,)) for w in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        got = [q.get(timeout=10) for _ in range(n * per)]
    finally:
        sys.setswitchinterval(interval)
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    assert sorted(got) == [(w, i) for w in range(n) for i in range(per)]
    for w in range(n):   # each producer's items in its own order
        assert [i for ww, i in got if ww == w] == list(range(per))
    assert q.qsize() == 0 and q._items == {}


def test_native_rings_are_independent(tmp_path):
    assert pnative.lib()._name != jnative.lib()._name
    pnative.trace_start()
    jnative.trace_start()
    try:
        pnative.record("port_only", 10, 20)
        jnative.record("reference_only", 30, 40)
        assert [e[0] for e in pnative.events_snapshot()] == ["port_only"]
        assert [e[0] for e in jnative.events_snapshot()] == \
            ["reference_only"]
        assert pnative.trace_enabled() and jnative.trace_enabled()
        assert pnative.export_chrome(tmp_path / "p.json", pid=5) == 1
        assert jnative.export_chrome(tmp_path / "j.json", pid=5) == 1
    finally:
        pnative.trace_stop()
        jnative.trace_stop()
    assert not pnative.trace_enabled()
    with open(tmp_path / "p.json") as f:
        port = json.load(f)
    with open(tmp_path / "j.json") as f:
        ref = json.load(f)
    assert [e["name"] for e in port["traceEvents"]] == ["port_only"]
    assert [e["name"] for e in ref["traceEvents"]] == ["reference_only"]
    buf = pnative.HostStagingBuffer(256)
    view = buf.view(np.float32, (8, 8))
    view[:] = 1.5
    assert pnative.host_stats()[0] >= 256 and float(view.sum()) == 96.0
    buf.free()


def test_threaded_loader_keeps_its_batches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((23, 5)).astype(np.float32)
    y = rng.integers(0, 9, (23,))
    threaded = DataLoader(TensorDataset([x, y]), batch_size=4,
                          num_workers=3, use_shared_memory=False, timeout=30)
    plain = DataLoader(TensorDataset([x, y]), batch_size=4)
    ref = JDataLoader(JTensorDataset([x, y]), batch_size=4, num_workers=3,
                      use_shared_memory=False)
    got = [[t.numpy() for t in b] for b in threaded]
    want = [[t.numpy() for t in b] for b in plain]
    ref_got = [[np.asarray(t) for t in b] for b in ref]
    assert len(got) == len(want) == len(ref_got) == 6
    for g, w, r in zip(got, want, ref_got):
        for a, b, c in zip(g, w, r):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    # a pass left early stops its workers through the closed queue
    it = iter(threaded)
    next(it)
    it.close()
