"""The StepMeter's store-backed straggler detection on the port
(``paddle_tpu_torch/observability/perf.py``), as the straggler part of
``tests/test_perf_metrology.py`` runs it on the reference, with planted
step times and a fake clock (the reference's chaos leg, a real slowed
process, is flaky between runs, so its timings are planted here):

- a fleet of three meters over one store flags the rank 20x slower, every
  rank arms triggered tracing, and after ``trace_steps`` each exports a
  trace and dumps a flight artifact naming the straggler;
- a uniform fleet, and a fleet of two, never flags;
- a store that fails after ``configure_straggler`` is counted, not raised;
- parity: the same planted step-ms series through the reference's and the
  port's meters, three ranks each over their own store with the same fake
  wall clock, publish the same ``__perf/*`` keys and values and the same
  flag JSON, round by round, and arm on the same steps;
- the same fleet over the port's real ``TCPStore``.
"""
import json

import pytest

from paddle_tpu_torch.observability import flight, metrics, perf, trace


class FakeStore:
    """Duck-typed in-process store (set/get/compare_set) a fake fleet
    shares."""

    def __init__(self):
        self.d = {}

    def set(self, k, v):
        self.d[k] = v.encode() if isinstance(v, str) else v

    def get(self, k):
        if k not in self.d:
            raise KeyError(k)
        return self.d[k]

    def compare_set(self, k, expected, desired):
        cur = self.d.get(k, b"").decode()
        if cur == expected:
            self.set(k, desired)
            return desired.encode(), True
        return self.d.get(k, b""), False


def _fleet(mod, store, tmp_path, n=3, **kw):
    meters = []
    for r in range(n):
        m = mod.StepMeter()
        m.configure_straggler(store, r, k=3.0, check_every=1,
                              trace_steps=2, min_ratio=1.5, window=4,
                              trace_dir=str(tmp_path), **kw)
        meters.append(m)
    return meters


@pytest.fixture()
def quiet_tracing():
    was_tr, was_fl = trace.TRACER.enabled, flight.RECORDER.enabled
    trace.TRACER.enabled = False
    trace.clear()
    yield
    trace.TRACER.enabled = was_tr
    flight.RECORDER.enabled = was_fl
    trace.clear()


def _run(meters, rounds, slow=None, slow_ms=200.0, fast_ms=10.0,
         after=None):
    """``rounds`` steps on every meter, each step's time planted into the
    window after it (the next publish carries it)."""
    for i in range(rounds):
        for r, m in enumerate(meters):
            with m.step():
                pass
            m._window[-1] = slow_ms if r == slow else fast_ms
            if after is not None:
                after(i, r, m)


def test_straggler_flagged_and_triggers_tracing(tmp_path, quiet_tracing):
    store = FakeStore()
    meters = _fleet(perf, store, tmp_path)
    _run(meters, 10, slow=2)
    flag = json.loads(store.get("__perf/straggler").decode())
    assert flag["rank"] == "2"
    assert flag["step_ms"] >= 50.0
    assert flag["fleet_median_ms"] < 50.0
    for m in meters:
        assert m.last_trigger is not None
        assert m.last_trigger["straggler"]["rank"] == "2"
        assert m.last_trigger["flight_path"] is not None
        dump = flight.load_dump(m.last_trigger["flight_path"])
        assert "straggler: rank 2" in dump["reason"]
        assert dump["meta"]["straggler"]["rank"] == "2"
    assert trace.TRACER.enabled is False
    merged = trace.merge_traces(str(tmp_path))
    assert trace.events_named(merged["traceEvents"],
                              "perf.straggler_flagged")


def test_no_flag_below_threshold_or_small_fleet(tmp_path, quiet_tracing):
    store = FakeStore()
    meters = _fleet(perf, store, tmp_path)
    _run(meters, 10)
    assert all(not m.armed() and m.last_trigger is None for m in meters)
    with pytest.raises(KeyError):
        store.get("__perf/straggler")
    two = _fleet(perf, FakeStore(), tmp_path, n=2)
    _run(two, 10, slow=1, slow_ms=500.0)
    assert all(not m.armed() for m in two)


def test_straggler_check_errors_are_counted_not_raised():
    class BrokenStore(FakeStore):
        def set(self, k, v):
            raise ConnectionError("store down")

    metrics.REGISTRY.clear()
    m = perf.StepMeter()
    m.configure_straggler(FakeStore(), 0, check_every=1)
    m._store = BrokenStore()
    for _ in range(3):
        with m.step():
            pass
    assert m._metrics["check_errors"].total() == 3


def _fake_clocks(monkeypatch, wall=1000.0):
    """The wall clock (``time.time``, the flag's stamp) and the step clock
    (``time.perf_counter_ns``) frozen; each moves only when the test moves
    it. Returns their [value] cells."""
    now, ns = [wall], [0]
    monkeypatch.setattr(perf.time, "time", lambda: now[0])
    monkeypatch.setattr(perf.time, "perf_counter_ns", lambda: ns[0])
    return now, ns


def _planted(meters, ns, ms_of):
    """One step on every meter, rank r's lasting ``ms_of(r)`` ms on the
    step clock."""
    for r, m in enumerate(meters):
        with m.step():
            ns[0] += int(ms_of(r) * 1e6)


def test_expired_flag_is_cleared_and_detection_resumes(tmp_path,
                                                       quiet_tracing,
                                                       monkeypatch):
    """A flag older than its TTL is cleared (by compare_set) and detection
    resumes: a later straggler is flagged."""
    now, ns = _fake_clocks(monkeypatch)
    store = FakeStore()
    meters = _fleet(perf, store, tmp_path)
    for _ in range(10):
        _planted(meters, ns, lambda r: 200.0 if r == 2 else 10.0)
    assert json.loads(store.get("__perf/straggler").decode())["rank"] == "2"
    for _ in range(5):      # the flag is live: rank 0 slows unflagged
        _planted(meters, ns, lambda r: 200.0 if r == 0 else 10.0)
    assert json.loads(store.get("__perf/straggler").decode())["rank"] == "2"
    now[0] += meters[0]._flag_ttl + 1
    _planted(meters, ns, lambda r: 200.0 if r == 0 else 10.0)
    flag = json.loads(store.get("__perf/straggler").decode())
    assert flag["rank"] == "0" and flag["ts"] == now[0]


def _parity_run(mod, tmp_path, monkeypatch):
    """The planted fleet through ``mod``'s meters, the step clock moving
    by the planted ms and the wall clock 0.5 s a step from 1000: the
    store's contents after each round, the arming steps and the
    triggers."""
    clock, ns = _fake_clocks(monkeypatch)
    store = FakeStore()
    meters = _fleet(mod, store, tmp_path)
    series = {0: [10.0, 11.0, 9.5, 10.5, 10.0, 10.2, 9.8, 10.1, 10.0, 10.3,
                  10.0, 9.9],
              1: [12.0, 12.5, 11.0, 30.0, 31.0, 29.5, 32.0, 30.5, 30.0,
                  31.5, 30.2, 29.9],
              2: [9.0, 9.5, 10.0, 10.5, 9.7, 9.9, 10.4, 10.0, 9.6, 10.1,
                  10.2, 9.8]}
    rounds, armed = [], []
    for i in range(12):
        for r, m in enumerate(meters):
            with m.step():
                ns[0] += int(series[r][i] * 1e6)
            clock[0] += 0.5
            armed.append(m.armed())
        rounds.append(dict(store.d))
    triggers = [m.last_trigger and m.last_trigger["straggler"]
                for m in meters]
    return rounds, armed, triggers


def test_straggler_parity_with_reference(tmp_path, quiet_tracing,
                                         monkeypatch):
    from paddle_tpu.observability import flight as jflight
    from paddle_tpu.observability import perf as jperf
    from paddle_tpu.observability import trace as jtrace
    was = jtrace.TRACER.enabled, jflight.RECORDER.enabled
    jtrace.TRACER.enabled = False
    try:
        want = _parity_run(jperf, tmp_path / "ref", monkeypatch)
    finally:
        jtrace.TRACER.enabled, jflight.RECORDER.enabled = was
        jtrace.clear()
    got = _parity_run(perf, tmp_path / "port", monkeypatch)
    assert got == want
    flag = json.loads(got[0][-1]["__perf/straggler"].decode())
    assert flag["rank"] == "1" and any(got[1])


def test_straggler_over_the_tcp_store(tmp_path, quiet_tracing):
    from paddle_tpu_torch.distributed.store import TCPStore
    server = TCPStore(is_master=True, world_size=1)
    clients = [TCPStore(port=server.port, world_size=1) for _ in range(3)]
    try:
        meters = []
        for r, c in enumerate(clients):
            m = perf.StepMeter()
            m.configure_straggler(c, r, k=3.0, check_every=1,
                                  trace_steps=2, min_ratio=1.5, window=4,
                                  trace_dir=str(tmp_path))
            meters.append(m)
        _run(meters, 10, slow=1, slow_ms=70.0)
        assert server.get("__perf/ranks") == b"0,1,2"
        flag = json.loads(server.get("__perf/straggler").decode())
        assert flag["rank"] == "1"
        assert {m.last_trigger["straggler"]["rank"] for m in meters} == {"1"}
    finally:
        for c in clients:
            c.close()
        server.close()
