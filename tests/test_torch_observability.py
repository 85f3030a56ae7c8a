"""The observability modules this slice ported, held to the reference's on
the same inputs, on the CPU (``paddle_tpu_torch.observability`` against
``paddle_tpu.observability``, ``hapi.callbacks.VisualDL``):

- ``trace``: ``chrome_events`` on both bases, the ``records`` and
  ``chrome_events`` aliases, ``PADDLE_TRACE_CAPACITY``, the export at exit
  and ``make_span``/``make_marker`` give what the reference gives on the
  same records;
- ``metrology``: ``scan_chain`` and ``_result`` give identical dicts from
  one scripted ``sample_fn``; ``run_probes`` names its probes and keys
  them as the reference does (``device="cpu"``), and without a card the
  default device raises;
- ``top``: ``fleet_rows`` and ``render`` give equal rows and strings from
  the same expo snapshots, and ``main`` scrapes a live endpoint found
  through the port's store;
- ``VisualDL`` writes a byte-identical ``scalars.tsv`` from the same logs.
"""
import contextlib
import io
import json
import os

import pytest
import torch

from paddle_tpu.hapi.callbacks import VisualDL as JVisualDL
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import metrology as jmetrology
from paddle_tpu.observability import top as jtop
from paddle_tpu.observability import trace as jtrace
import paddle_tpu_torch
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.hapi.callbacks import VisualDL
from paddle_tpu_torch.observability import expo as pexpo
from paddle_tpu_torch.observability import metrics as pmetrics
from paddle_tpu_torch.observability import metrology as pmetrology
from paddle_tpu_torch.observability import top as ptop
from paddle_tpu_torch.observability import trace as ptrace

RECORDS = [
    {"kind": "span", "name": "store.get", "t0": 1_000_000, "t1": 1_250_500,
     "tid": 7, "span_id": 1, "parent_id": None, "attrs": {"key": "a"},
     "c0": 10_000, "c1": 90_000},
    {"kind": "span", "name": "perf.step", "t0": 2_000_000,
     "t1": 2_100_000, "tid": 7, "span_id": 2, "parent_id": 1,
     "attrs": {"step_ms": 0.1}},
    {"kind": "event", "name": "metrology.rep", "t0": 3_000_123,
     "t1": 3_000_123, "tid": 9, "span_id": None, "parent_id": 2,
     "attrs": {"ms": 1.5}},
]


def _loaded(mod, monkeypatch, capacity=None, recs=RECORDS):
    if capacity is not None:
        monkeypatch.setenv("PADDLE_TRACE_CAPACITY", str(capacity))
    t = mod.Tracer()
    for r in recs:
        t._push(dict(r))
    return t


@pytest.mark.parametrize("base", ["wall", "perf"])
def test_chrome_events_equal_the_reference(base, monkeypatch):
    monkeypatch.setattr(ptrace, "_WALL0", jtrace._WALL0)
    monkeypatch.setattr(ptrace, "_PERF0", jtrace._PERF0)
    port = _loaded(ptrace, monkeypatch).chrome_events(base=base)
    ref = _loaded(jtrace, monkeypatch).chrome_events(base=base)
    assert port == ref
    if base == "perf":
        assert port[0]["ts"] == 1000.0 and port[0]["tdur"] == 80.0


def test_trace_aliases_capacity_and_span_makers(monkeypatch):
    assert ptrace.records == ptrace.TRACER.records
    assert ptrace.chrome_events == ptrace.TRACER.chrome_events
    recs = [dict(RECORDS[1], span_id=i) for i in range(10)]
    port = _loaded(ptrace, monkeypatch, capacity=4, recs=recs)
    ref = _loaded(jtrace, monkeypatch, capacity=4, recs=recs)
    assert port.capacity == ref.capacity == 4
    assert port.dropped == ref.dropped == 6
    assert port.records() == ref.records()
    monkeypatch.setenv("PADDLE_TRACE_CAPACITY", "not a number")
    assert ptrace.Tracer().capacity == jtrace.Tracer().capacity == 65536
    assert ptrace.make_span("restore", 12, 3.5, pid=1, tid=2, gen=1) == \
        jtrace.make_span("restore", 12, 3.5, pid=1, tid=2, gen=1)
    assert ptrace.make_marker("kill", 12, pid=1, node=0) == \
        jtrace.make_marker("kill", 12, pid=1, node=0)


def test_export_at_exit_equals_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(ptrace, "_WALL0", jtrace._WALL0)
    monkeypatch.setattr(ptrace, "_PERF0", jtrace._PERF0)
    out = {}
    for name, mod in (("torch", ptrace), ("jax", jtrace)):
        t = _loaded(mod, monkeypatch)
        t._dir = str(tmp_path / name)
        t._atexit_export()
        (path,) = os.listdir(tmp_path / name)
        assert path == f"trace.{os.getpid()}.json"
        with open(tmp_path / name / path) as f:
            out[name] = json.load(f)
    assert out["torch"] == out["jax"]
    empty = ptrace.Tracer()
    empty._dir = str(tmp_path / "empty")
    empty._atexit_export()          # nothing recorded: nothing written
    assert not os.path.exists(tmp_path / "empty")


SCRIPTS = {
    "settles": [0.5, 0.010, 0.011, 0.0105, 0.5, 0.5],
    "never_settles": [0.1, 0.01, 0.02, 0.04, 0.08, 0.001, 0.3, 0.05, 0.07,
                      0.09, 0.2],
    "zero": [0.0] * 12,
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("kw", [{}, {"warmup": 0, "min_reps": 2},
                                {"max_reps": 1, "min_reps": 3},
                                {"stability_rtol": 0.5}])
def test_scan_chain_and_result_equal_the_reference(script, kw):
    def run(mod):
        it = iter(SCRIPTS[script])
        st = mod.scan_chain(lambda: next(it), probe="p", **kw)
        return st, mod._result("p", 123.456789, "GB/s", st, n=8)
    assert run(pmetrology) == run(jmetrology)


def test_run_probes_reports_as_the_reference():
    kw = {"warmup": 0, "min_reps": 1, "max_reps": 1}
    port = pmetrology.run_probes("smoke", scan_kw=kw, device="cpu")
    ref = jmetrology.run_probes("smoke", scan_kw=kw)
    assert port["platform"] == "cpu" and port["device"] == "cpu"
    assert set(port) == set(ref)
    assert [p["probe"] for p in port["probes"]] == \
        [p["probe"] for p in ref["probes"]]
    for a, b in zip(port["probes"], ref["probes"]):
        assert set(a) - {"plane"} == set(b) - {"plane"}
        assert a["unit"] == b["unit"] and a["value"] > 0
    bus = pmetrology.probe_value(port, "collective_bus")
    assert bus["plane"] == "local" and bus["world"] == 1
    assert pmetrology.probe_value(port, "nope") is None


def test_metrology_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pmetrology.run_probes("smoke")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pmetrology.probe_gemm(n=8)


def _serving_registry(mod, scale):
    reg = mod.Registry()
    reg.gauge("serving_batch_occupancy").set(3 * scale)
    reg.gauge("serving_free_pages").set(100 + scale)
    reg.counter("serving_tokens_generated").inc(40 * scale, replica="a")
    reg.counter("serving_tokens_generated").inc(2, replica="b")
    reg.counter("serving_prefix_lookups").inc(8)
    reg.counter("serving_prefix_hits").inc(scale)
    h = reg.histogram("serving_ttft_ms")
    for v in (1.0, 4.0 * scale, 30.0, 250.0):
        h.observe(v, replica="a")
    h.observe(7.0, replica="b")
    if scale == 2:
        reg.counter("serving_router_routed").inc(11)
        reg.counter("serving_router_requeued").inc(1)
        reg.gauge("serving_fleet_replicas").set(2)
    return reg.snapshot()


def test_fleet_rows_and_render_equal_the_reference():
    for mod in (pmetrics, jmetrics):
        snaps = {"replica0": _serving_registry(mod, 1),
                 "router": _serving_registry(mod, 2)}
        later = {k: dict(v) for k, v in snaps.items()}
        later["replica0"] = _serving_registry(mod, 3)
        rows, ref_rows = ptop.fleet_rows(snaps), jtop.fleet_rows(snaps)
        assert rows == ref_rows
        assert ptop.render(rows) == jtop.render(ref_rows)
        assert ptop.render(ptop.fleet_rows(later), prev=rows, dt=2.0) == \
            jtop.render(jtop.fleet_rows(later), prev=ref_rows, dt=2.0)
    assert "[router: routed=11 requeued=1" in ptop.render(rows)


def test_top_scrapes_an_endpoint_found_through_the_store():
    reg = pmetrics.Registry()
    reg.counter("serving_tokens_generated").inc(5)
    reg.gauge("serving_free_pages").set(12)
    server = pexpo.serve_metrics(registry=reg)
    store = TCPStore(port=0, is_master=True)
    try:
        pexpo.announce(store, "replica0", server.address)
        assert ptop.scrape(server.address)["metrics"][
            "serving_free_pages"]["series"][0]["value"] == 12
        for argv in (["--store", f"127.0.0.1:{store.port}", "--once"],
                     ["--endpoints", f"replica0={server.address}", "-n", "2",
                      "--interval", "0.05"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert ptop.main(argv) == 0
            out = buf.getvalue()
            assert "(1/1 endpoints)" in out and "replica0" in out
        assert out.count("replica0") == 2 and "0.0" in out
    finally:
        server.close()
        store.close()
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            ptop.main([])


def test_visualdl_writes_what_the_reference_writes(tmp_path):
    logs = [{"loss": 2.5, "acc": [0.5], "lr": 1e-3, "step": 1},
            {"loss": 1.25, "note": "x"}, None, {"loss": float("nan")}]
    for name, cls in (("torch", VisualDL), ("jax", JVisualDL)):
        cb = cls(str(tmp_path / name))
        for i, lg in enumerate(logs):
            cb.on_train_batch_end(i, lg)
    port = (tmp_path / "torch" / "scalars.tsv").read_bytes()
    assert port == (tmp_path / "jax" / "scalars.tsv").read_bytes()
    assert port.startswith(b"1\tloss\t2.5\n1\tlr\t0.001\n1\tstep\t1\n")


def test_package_exports():
    from paddle_tpu_torch import observability
    assert observability.metrology is pmetrology
    assert paddle_tpu_torch.profiler.Profiler is not None
    assert "metrology" in observability.__all__
