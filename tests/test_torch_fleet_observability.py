"""The telemetry the port's fleet calls, held to the reference's on the
same inputs (``paddle_tpu_torch/observability`` against
``paddle_tpu/observability``): the metrics fleet view over the membership
store (``publish``, ``fleet_snapshot``, ``merge_snapshots``,
``unpublish``, ``published_ranks``, ``cas_index``), the trace merge and
query helpers, ``requesttrace`` (``arrival_from_origin``,
``request_timeline``), the flight ring, the SLO engine with its burn flag
and ``from_env``, and ``expo`` (``render_prometheus`` and endpoint
discovery). Each comparison is exact: the port's modules are copies, and
their outputs must not drift from the reference's."""
import json
import time

import pytest

from paddle_tpu.observability import expo as jexpo
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import requesttrace as jrt
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import trace as jtrace
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.observability import expo as pexpo
from paddle_tpu_torch.observability import flight as pflight
from paddle_tpu_torch.observability import metrics as pmetrics
from paddle_tpu_torch.observability import requesttrace as prt
from paddle_tpu_torch.observability import slo as pslo
from paddle_tpu_torch.observability import trace as ptrace


@pytest.fixture
def store():
    s = TCPStore(port=0, is_master=True)
    yield s
    s.close()


def _registry(mod, scale=1):
    reg = mod.Registry()
    reg.counter("reqs", "requests").inc(3 * scale, route="a")
    reg.counter("reqs", "requests").inc(scale, route="b")
    reg.gauge("free_pages", "free").set(17 * scale)
    h = reg.histogram("ttft_ms", "ttft")
    for v in (0.3, 2.0, 40.0 * scale, 900.0):
        h.observe(v)
    return reg


def test_merge_snapshots_equal_the_reference():
    snaps = {"0": _registry(pmetrics).snapshot(),
             "7": _registry(pmetrics, scale=2).snapshot()}
    assert pmetrics.merge_snapshots(snaps) == jmetrics.merge_snapshots(snaps)
    # and each package's registry snapshots the same recordings alike
    a, b = _registry(pmetrics).snapshot(), _registry(jmetrics).snapshot()
    for snap in (a, b):
        snap.pop("ts_unix", None)
    assert a["metrics"] == b["metrics"]


def test_fleet_snapshot_across_both_packages(store):
    """A port publisher and a reference publisher share one store; both
    packages' fleet views agree, scope out a rank whose heartbeat went
    stale, and forget an unpublished one."""
    _registry(pmetrics).publish(store, 3)
    _registry(jmetrics, scale=2).publish(store, 4)
    assert pmetrics.published_ranks(store) \
        == jmetrics.published_ranks(store) == ["3", "4"]
    full = pmetrics.fleet_snapshot(store)
    assert full == jmetrics.fleet_snapshot(store)
    assert full["ranks"] == ["3", "4"]
    store.heartbeat(4)
    time.sleep(0.3)
    store.heartbeat(3)
    live = pmetrics.fleet_snapshot(store, live_timeout=0.2)
    assert live == jmetrics.fleet_snapshot(store, live_timeout=0.2)
    assert live["ranks"] == ["3"]
    pmetrics.unpublish(store, 3)
    assert jmetrics.published_ranks(store) == ["4"]


def test_cas_index_interleaved_writers(store):
    pmetrics.cas_index(store, "idx", "b")
    jmetrics.cas_index(store, "idx", "a")
    pmetrics.cas_index(store, "idx", "c")
    assert store.get("idx") == b"a,b,c"
    jmetrics.cas_index(store, "idx", "b", add=False)
    pmetrics.cas_index(store, "idx", "a", add=False)
    assert store.get("idx") == b"c"


def _shard(tmp_path, mod, pid):
    tr = mod.Tracer(capacity=64)
    tr.enable()
    with tr.span("serve.route", rid="1", replica=0):
        tr.event("req.admit", rid="1")
    with tr.span("serve.prefill", rid="1"):
        pass
    path = tr.export(str(tmp_path / f"trace.{pid}.json"))
    return path


def test_trace_merge_and_queries_equal_the_reference(tmp_path):
    _shard(tmp_path, ptrace, 11)
    _shard(tmp_path, jtrace, 12)
    (tmp_path / "trace.13.json").write_text("{torn")
    merged = ptrace.merge_traces(str(tmp_path))
    assert merged == jtrace.merge_traces(str(tmp_path))
    ev = merged["traceEvents"]
    for name in ("serve.route", "serve.prefill"):
        got = ptrace.spans_named(ev, name)
        assert got == jtrace.spans_named(ev, name) and len(got) == 2
        assert [ptrace.span_end_us(e) for e in got] \
            == [jtrace.span_end_us(e) for e in got]
    assert ptrace.events_named(ev, "req.admit") \
        == jtrace.events_named(ev, "req.admit")
    assert ptrace.enabled() is False


def _request_story():
    """A re-routed request's merged trace: submit and routes on the
    router (pid 1), admit and prefill on replica 0 (pid 2), which dies,
    the death verdict, the re-route, and the survivor's (pid 3) work."""
    S, M = jtrace.make_span, jtrace.make_marker
    t = 1_000_000.0
    return [
        M("serve.submit", t, pid=1, rid="5", origin_unix_us=t),
        S("serve.route", t + 10, 5, pid=1, rid="5", replica=0, requeue=0),
        M("req.admit", t + 200, pid=2, rid="5", origin_unix_us=t),
        S("serve.prefill", t + 210, 300, pid=2, rid="5"),
        S("serve.decode_step", t + 600, 40, pid=2, rids=["5", "6"]),
        M("serve.replica_death", t + 3000, pid=1, replica=0),
        S("serve.drain", t + 3001, 20, pid=1, replica=0, reason="death"),
        S("serve.route", t + 3010, 5, pid=1, rid="5", replica=1,
          requeue=1),
        M("req.admit", t + 3200, pid=3, rid="5", origin_unix_us=t),
        S("serve.prefill", t + 3210, 280, pid=3, rid="5"),
        S("serve.decode_step", t + 3600, 40, pid=3, rids=["5"]),
        M("req.done", t + 4000, pid=1, rid="5", replica=1, status="ok"),
    ]


def test_request_timeline_equals_the_reference():
    events = _request_story()
    assert prt.request_ids(events) == jrt.request_ids(events)
    tl = prt.request_timeline(events, "5")
    assert tl == jrt.request_timeline(events, "5")
    assert tl["found"] and tl["requeues"] >= 1
    assert prt.render_timeline(tl) == jrt.render_timeline(tl)
    assert prt.arrival_from_origin(100.0, now_unix=103.5, now_perf=50.0) \
        == jrt.arrival_from_origin(100.0, now_unix=103.5, now_perf=50.0) \
        == 46.5


def test_flight_ring_keeps_the_newest_and_dumps(tmp_path):
    dumps = {}
    for name, mod in (("port", pflight), ("jax", jflight)):
        rec = mod.FlightRecorder(capacity=3)
        rec.enabled = True
        for i in range(5):
            rec.record("event", f"e{i}", i=i)
        path = rec.dump(str(tmp_path / f"{name}.json"), reason="test")
        got = mod.load_dump(path)
        dumps[name] = ([(e["kind"], e["name"], e["data"])
                        for e in got["events"]], got["reason"],
                       got["capacity"])
    assert dumps["port"] == dumps["jax"]
    assert [n for _, n, _ in dumps["port"][0]] == ["e2", "e3", "e4"]


def test_slo_engine_and_flag_equal_the_reference(store, monkeypatch):
    verdicts = {}
    for name, mod in (("port", pslo), ("jax", jslo)):
        eng = mod.SLOEngine([mod.Objective("availability", target=0.9,
                                           windows=((10.0, 2.0),),
                                           min_events=4)], name="t")
        for i in range(10):
            eng.record_request(rid=i, status="ok" if i % 3 else "timeout",
                               now=100.0 + i)
        verdicts[name] = eng.evaluate(now=110.0)
    assert verdicts["port"] == verdicts["jax"] and verdicts["port"]
    assert pslo.flag_up(store) is jslo.flag_up(store) is False
    store.set(jslo._FLAG_KEY, json.dumps({"ts": time.time()}))
    assert pslo.flag_up(store, ttl=30) is jslo.flag_up(store, ttl=30) \
        is True
    store.set(jslo._FLAG_KEY, json.dumps({"ts": time.time() - 60}))
    assert pslo.flag_up(store, ttl=30) is jslo.flag_up(store, ttl=30) \
        is False
    monkeypatch.delenv("PADDLE_SLO", raising=False)
    assert pslo.from_env() is None and jslo.from_env() is None
    monkeypatch.setenv("PADDLE_SLO", "1")
    assert [o.describe() for o in pslo.from_env().objectives] \
        == [o.describe() for o in jslo.from_env().objectives]


def test_expo_rendering_and_discovery(store, monkeypatch):
    snap = _registry(pmetrics).snapshot()
    assert pexpo.render_prometheus(snap) == jexpo.render_prometheus(snap)
    monkeypatch.delenv("PADDLE_METRICS_PORT", raising=False)
    monkeypatch.setattr(pexpo, "_CONFIGURED", None)
    assert pexpo.start_if_configured() is None
    pexpo.announce(store, "replica0", "127.0.0.1:9001")
    jexpo.announce(store, "router", "127.0.0.1:9000")
    assert pexpo.endpoints(store) == jexpo.endpoints(store) == {
        "replica0": "127.0.0.1:9001", "router": "127.0.0.1:9000"}
    assert not pexpo.retire_if_current(store, "replica0", "127.0.0.1:1")
    assert pexpo.retire_if_current(store, "replica0", "127.0.0.1:9001")
    jexpo.unannounce(store, "router")
    assert pexpo.endpoints(store) == {}
