"""The port's collectives, comm plane, quantized wire, launcher, spawn,
env contract and ``DistributedBatchSampler`` (``paddle_tpu_torch.
distributed``), against numpy and the JAX package.

Multi-process cases run two ranks over gloo on the CPU through the
port's launcher or ``spawn``, each under its own timeout. Every fp32
collective is held bit-equal to numpy computed as the reference
computes it (AVG is ``(a + b) / 2`` in fp32). The quantized all-reduce is
held bit-equal to the reference's two-rank ring
(``paddle_tpu/distributed/collective.py`` ``_ring_allreduce_p2p_impl``)
evaluated with the reference's codec on the same inputs; the codec's
codes and scales are held bit-equal to the reference's."""
import collections
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import comm_quant as jcq
from paddle_tpu.io import DistributedBatchSampler as JSampler

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import comm_plane
from paddle_tpu_torch.distributed import comm_quant as cq
from paddle_tpu_torch.io import DistributedBatchSampler

from _torch_dist_helpers import assert_ranks_ok, launch

QCFG = dict(block_size=8)

_COLLECTIVES = """
import time
import numpy as np
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import comm_quant as cq

dist.init_parallel_env(device="cpu")
r = dist.get_rank()
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
x = [np.random.default_rng(i).standard_normal(37).astype(np.float32)
     for i in range(2)]
def mine():
    return torch.from_numpy(x[r].copy())
want = {dist.ReduceOp.SUM: x[0] + x[1],
        dist.ReduceOp.MAX: np.maximum(x[0], x[1]),
        dist.ReduceOp.MIN: np.minimum(x[0], x[1]),
        dist.ReduceOp.PROD: x[0] * x[1],
        dist.ReduceOp.AVG: (x[0] + x[1]) / np.float32(2)}
for op, w in want.items():
    t = mine()
    dist.all_reduce(t, op)
    assert np.array_equal(t.numpy(), w), op
    t = mine()
    dist.reduce(t, dst=1, op=op)
    assert np.array_equal(t.numpy(), w if r == 1 else x[r]), op
parts = [torch.from_numpy(x[r][:36].reshape(2, 18)[k].copy())
         for k in range(2)]
for op in (dist.ReduceOp.SUM, dist.ReduceOp.AVG, dist.ReduceOp.MAX):
    t = torch.zeros(18)
    dist.reduce_scatter(t, parts, op=op)
    a, b = x[0][:36].reshape(2, 18)[r], x[1][:36].reshape(2, 18)[r]
    w = {dist.ReduceOp.SUM: a + b, dist.ReduceOp.AVG: (a + b) / np.float32(2),
         dist.ReduceOp.MAX: np.maximum(a, b)}[op]
    assert np.array_equal(t.numpy(), w), op
rows = []
dist.all_gather(rows, mine())
assert [row.numpy().tolist() for row in rows] == [v.tolist() for v in x]
objs = []
dist.all_gather_object(objs, {"rank": r})
assert objs == [{"rank": 0}, {"rank": 1}]
t = mine()
dist.broadcast(t, src=1)
assert np.array_equal(t.numpy(), x[1])
ol = [r, "same"]
dist.broadcast_object_list(ol, src=1)
assert ol == [1, "same"]
out = []
dist.scatter_object_list(out, [10, 11] if r == 0 else None, src=0)
assert out == [10 + r]
t = torch.zeros(37)
dist.scatter(t, [torch.from_numpy(v) for v in x] if r == 0 else None, src=0)
assert np.array_equal(t.numpy(), x[r])
got = []
dist.alltoall(got, [torch.full((3,), 10.0 * r + k) for k in range(2)])
assert [row.tolist() for row in got] == [[10.0 * s + r] * 3 for s in range(2)]
t = torch.zeros(4)
dist.alltoall_single(t, torch.arange(4.0) + 10 * r)
assert t.tolist() == [2.0 * r, 2.0 * r + 1, 10 + 2.0 * r, 11 + 2.0 * r]
if r == 0:
    dist.send(torch.arange(5.0), 1)
    dist.isend(torch.arange(3.0) * 2, 1).wait()
else:
    t = torch.zeros(5)
    dist.recv(t, 0)
    assert t.tolist() == [0, 1, 2, 3, 4]
    t = torch.zeros(3)
    dist.irecv(t, 0).wait()
    assert t.tolist() == [0, 2, 4]
buf = torch.zeros(2)
reqs = dist.batch_isend_irecv([
    dist.P2POp(dist.isend, torch.full((2,), float(r)), 1 - r),
    dist.P2POp(dist.irecv, buf, 1 - r)])
for q in reqs:
    q.wait()
assert buf.tolist() == [1.0 - r] * 2
g = dist.new_group([0, 1])
t = torch.ones(3)
dist.all_reduce(t, group=g)
assert t.tolist() == [2.0] * 3
# a pending async all_reduce, waited with a deadline
t = torch.full((20000,), float(r + 1))
w = dist.all_reduce(t, op=dist.ReduceOp.AVG, sync_op=False)
assert isinstance(w, dist.CollectiveWork)
assert w.wait(timeout=30)
assert bool((t == 1.5).all())
# the quantized wire
cfg = cq.QuantConfig(block_size=8)
q_sum = torch.from_numpy(x[r].copy())
dist.all_reduce(q_sum, dist.ReduceOp.SUM, quant=cfg)
q_avg = torch.from_numpy(x[r].copy())
dist.all_reduce(q_avg, dist.ReduceOp.AVG, quant=cfg)
rows = []
dist.all_gather(rows, q_sum)
assert torch.equal(rows[0], rows[1])
qrows = []
dist.all_gather(qrows, mine(), quant=cfg)
for k in range(2):
    assert torch.equal(qrows[k], cq.quantization_roundtrip(
        torch.from_numpy(x[k]), cfg))
q_rs = torch.zeros(18)
dist.reduce_scatter(q_rs, parts, quant=cfg)
np.savez(f"{OUT}/rank{r}.npz", q_sum=q_sum.numpy(), q_avg=q_avg.numpy(),
         q_rs=q_rs.numpy())
dist.barrier()
# a receive whose sender never sends (last: gloo closes the pair on a
# receive's timeout, so no collective may follow it)
if r == 1:
    t0 = time.monotonic()
    try:
        dist.recv(torch.zeros(2), 0, timeout=1.0)
        raise SystemExit("recv returned without a sender")
    except dist.P2PTimeout as e:
        assert "deadline" in str(e), e
        assert time.monotonic() - t0 < 20
else:
    time.sleep(3.0)
print(f"rank{r} ok", flush=True)
"""


def _ring_two_ranks(x0, x1, cfg):
    """The reference's two-rank quantized ring
    (``_ring_allreduce_p2p_impl``), SUM, with the reference's codec."""
    m = 2
    flat = [np.asarray(v, np.float32).reshape(-1) for v in (x0, x1)]
    size = flat[0].size
    chunk = -(-size // m)
    chunk = -(-chunk // cfg.block_size) * cfg.block_size
    parts = [np.pad(f, (0, m * chunk - size)).reshape(m, chunk)
             for f in flat]

    def rt(v):
        return np.asarray(jcq.quantization_roundtrip(jnp.asarray(v), cfg))

    owned = {}
    for pos in range(m):
        left = (pos - 1) % m
        owned[(pos + 1) % m] = rt(parts[left][left]) + parts[pos][(pos - 1) % m]
    out = np.concatenate([rt(owned[c]) for c in range(m)])
    return out[:size]


def test_collectives_two_ranks(tmp_path):
    proc, logs = launch(tmp_path, f"OUT = {str(tmp_path)!r}\n" + _COLLECTIVES)
    assert_ranks_ok(proc, logs)
    x = [np.random.default_rng(i).standard_normal(37).astype(np.float32)
         for i in range(2)]
    jcfg = jcq.QuantConfig(**QCFG)
    want = _ring_two_ranks(x[0], x[1], jcfg)
    parts = [v[:36].reshape(2, 18) for v in x]
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(got["q_sum"], want)
        np.testing.assert_array_equal(got["q_avg"], want / np.float32(2))
        # the quantized reduce-scatter: the peer's part crosses the wire
        other = np.asarray(jcq.quantization_roundtrip(
            jnp.asarray(parts[1 - r][r]), jcq.QuantConfig(**QCFG)))
        np.testing.assert_array_equal(got["q_rs"], other + parts[r][r])


# -- the launcher and spawn ------------------------------------------------
_ENV_WORKER = """
import os
import paddle_tpu_torch.distributed as dist
env = dist.init_parallel_env(device="cpu")
keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
        "PADDLE_LOCAL_SIZE")
print("env", [os.environ[k] for k in keys], env.rank, env.world_size,
      env.local_rank, str(env.device), flush=True)
print(f"rank{dist.get_rank()} ok", flush=True)
"""


def test_launcher_env_contract_and_workerlogs(tmp_path):
    proc, logs = launch(tmp_path, _ENV_WORKER)
    assert_ranks_ok(proc, logs)
    assert sorted(logs) == ["workerlog.0", "workerlog.1"]
    for r in range(2):
        assert f"env ['{r}', '2', '{r}', '2'] {r} 2 {r} cpu" in \
            logs[f"workerlog.{r}"]


_FAIL_WORKER = """
import os, sys, time
if os.environ["PADDLE_TRAINER_ID"] == "1":
    sys.exit(1)
time.sleep(60)
"""


def test_launcher_tears_down_when_a_rank_fails(tmp_path):
    t0 = time.monotonic()
    proc, logs = launch(tmp_path, _FAIL_WORKER, timeout=60)
    assert proc.returncode == 1
    assert time.monotonic() - t0 < 30      # rank 0 was not waited for
    assert "tearing down ranks [0]" in proc.stderr


@pytest.mark.parametrize("flag", ["--elastic", "--max_restarts",
                                  "--host_store", "--min_nnodes"])
def test_launcher_refuses_the_control_plane(flag):
    """The control plane's flags, once refused naming ROADMAP A8, parse as
    the reference's launcher parses them."""
    from paddle_tpu.distributed.launch.main import _parse as jparse

    from paddle_tpu_torch.distributed.launch.main import _parse
    argv = [flag, "2", "train.py"]
    want = jparse(argv)
    got = _parse(argv)
    assert {k: got[k] for k in want} == want
    assert got[flag[2:]] == want[flag[2:]] != \
        _parse(["train.py"])[flag[2:]]


def test_launcher_parses_the_reference_options():
    from paddle_tpu_torch.distributed.launch.main import _parse, _rank_env
    opts = _parse(["--nnodes", "2", "--nproc_per_node", "4", "--rank", "1",
                   "--master", "h:5", "--log_dir", "d", "--gpus", "0,1",
                   "train.py", "--lr", "1"])
    assert (opts["nnodes"], opts["nproc_per_node"], opts["rank"],
            opts["master"], opts["log_dir"], opts["script"]) == \
        (2, 4, 1, "h:5", "d", ["train.py", "--lr", "1"])
    env = _rank_env({}, 5, 8, "h:5", 1, 4)
    assert env == {"PADDLE_TRAINER_ID": "5", "PADDLE_TRAINERS_NUM": "8",
                   "PADDLE_LOCAL_RANK": "1", "PADDLE_LOCAL_SIZE": "4",
                   "PADDLE_MASTER": "h:5"}


def test_spawn_sets_the_env_and_the_backend(tmp_path, monkeypatch):
    import _torch_dist_helpers as h
    for k, v in h.rank_env().items():
        monkeypatch.setenv(k, v)
    dist.spawn(h.spawn_all_reduce, args=(str(tmp_path),), nprocs=2,
               backend="gloo", timeout=120)
    for r in range(2):
        got = eval((tmp_path / f"rank{r}.txt").read_text())
        assert got == (3.0, "gloo", [str(r), "2", str(r), "gloo"])


def test_spawn_raises_when_a_rank_fails(monkeypatch):
    import _torch_dist_helpers as h
    for k, v in h.rank_env().items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="rank1"):
        dist.spawn(h.spawn_fail_rank1, nprocs=2, timeout=120)


# -- the env contract and the device rule ----------------------------------
def test_world_of_one_process_is_an_identity():
    assert dist.get_world_size() == 1 and dist.get_rank() == 0
    t = torch.arange(4.0)
    dist.all_reduce(t, dist.ReduceOp.SUM)
    dist.broadcast(t, 0)
    assert t.tolist() == [0, 1, 2, 3]
    rows = []
    dist.all_gather(rows, t)
    assert len(rows) == 1 and torch.equal(rows[0], t)
    assert dist.all_reduce(t, sync_op=False).wait()


_WORLD_OF_ONE = """
import torch
import torch.distributed as tdist
import paddle_tpu_torch.distributed as dist
dist.init_parallel_env(device="cpu")
calls = []
for name in ("all_reduce", "all_gather", "broadcast", "barrier"):
    def counted(*a, _fn=getattr(tdist, name), _name=name, **k):
        calls.append(_name)
        return _fn(*a, **k)
    setattr(tdist, name, counted)
t = torch.arange(4.0)
dist.all_reduce(t)
dist.broadcast(t, 0)
rows = []
dist.all_gather(rows, t)
dist.barrier()
assert t.tolist() == [0, 1, 2, 3] and len(rows) == 1, (t, rows)
print("calls", sorted(calls), flush=True)
print(f"rank{dist.get_rank()} ok", flush=True)
"""


def test_live_world_of_one_runs_collectives_through_the_backend(tmp_path):
    """A process group of one rank is live: its collectives reach the
    backend (only a sub-group of one in a larger world is an identity)."""
    proc, logs = launch(tmp_path, _WORLD_OF_ONE, nproc=1)
    assert_ranks_ok(proc, logs, nproc=1)
    assert "calls ['all_gather', 'all_reduce', 'barrier', 'broadcast']" in \
        logs["workerlog.0"], logs


def test_init_without_a_card_names_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dist.init_parallel_env()


def test_nccl_with_more_ranks_than_cards_names_gloo(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_MASTER", "127.0.0.1:1")
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        dist.init_parallel_env()
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        dist.init_parallel_env(backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()


# -- the comm plane ----------------------------------------------------------
class _Wire:
    """A backend ``Work`` whose collective the test lands by hand."""

    def __init__(self, log=None):
        self.fut = torch.futures.Future()
        self.waits = 0
        self.log = log

    def get_future(self):
        return self.fut

    def wait(self):
        self.waits += 1
        if self.log is not None:
            self.log.append("backend wait")
        return True

    def land(self, value=None):
        self.fut.set_result(value)


class _FakeClock:
    """A clock for ``CommPlane(clock=)`` that moves only when the test
    moves it; it counts each thread's reads."""

    def __init__(self):
        self.ns = 0
        self.reads = collections.Counter()

    def monotonic_ns(self):
        self.reads[threading.get_ident()] += 1
        return self.ns

    def advance_ms(self, ms):
        self.ns += int(ms * 1e6)


def _launch(plane, wire, then=None, label="w"):
    return plane.launch(lambda: wire, then=then, label=label)


class TestCommPlane:
    def test_pending_then_completed(self):
        wire = _Wire()
        w = _launch(comm_plane.CommPlane(), wire, then=lambda: 42)
        assert not w.is_completed()
        wire.land()
        assert w.result() == 42 and w.is_completed() and wire.waits == 1
        assert w.result() == 42 and wire.waits == 1     # settled once

    def test_wait_timeout_raises_p2ptimeout(self):
        wire = _Wire()
        w = _launch(comm_plane.CommPlane(), wire, label="stuck")
        with pytest.raises(dist.P2PTimeout, match="deadline"):
            w.wait(timeout=0.15)
        wire.land()
        assert w.wait()

    def test_transport_error_raises_on_waiter(self):
        plane = comm_plane.CommPlane()
        wire = _Wire()
        w = _launch(plane, wire, then=lambda: 1 / 0, label="boom")
        wire.fut.set_exception(RuntimeError("wire fell over"))
        with pytest.raises(RuntimeError, match="wire fell over"):
            w.wait()
        assert wire.waits == 0      # a failed collective is not settled
        plane.drain()    # observed already: not raised again

    def test_drain_clears_pending_and_counts_exposure(self):
        plane = comm_plane.CommPlane()
        wires = [_Wire() for _ in range(3)]
        for i, wire in enumerate(wires):
            _launch(plane, wire, label=f"w{i}")

        def land_in_turn():
            for wire in wires:
                time.sleep(0.01)
                wire.land()
        threading.Thread(target=land_in_turn).start()
        plane.drain()
        assert plane.pending_count() == 0
        st = plane.stats()
        assert st["works"] == 3 and st["comm_ms"] >= 30
        assert 0 < st["exposed_ms"] <= st["comm_ms"]
        assert 0.0 <= st["overlap_efficiency"] <= 1.0

    def test_thens_run_once_in_launch_order(self):
        seen = []
        plane = comm_plane.CommPlane()
        wires = [_Wire() for _ in range(8)]
        for i, wire in enumerate(wires):
            _launch(plane, wire, then=lambda i=i: seen.append(i))
        for wire in reversed(wires):        # landing order is the backend's
            wire.land()
        plane.drain()
        plane.drain()
        assert seen == list(range(8))

    def test_optimizer_step_drains_plane(self):
        from paddle_tpu_torch.optimizer.optimizer import run_pre_step_hooks
        wire, done = _Wire(), []
        _launch(comm_plane.get_plane(), wire, then=lambda: done.append(1),
                label="pre-step")
        threading.Timer(0.05, wire.land).start()
        run_pre_step_hooks()
        assert done == [1]
        assert comm_plane.get_plane().pending_count() == 0

    def test_backend_wait_comes_before_then(self):
        """The backend's ``wait`` (which orders the waiter's stream after
        the collective) runs before ``then`` reads the result."""
        log = []
        wire = _Wire(log)
        w = _launch(comm_plane.CommPlane(), wire,
                    then=lambda: log.append("then"))
        wire.land()
        w.wait()
        assert log == ["backend wait", "then"]

    def test_concurrent_waiters_settle_each_work_once(self):
        """More waiting threads than cores, with a short switch interval:
        every work's ``then`` runs once, and every waiter sees it ran."""
        import sys
        plane = comm_plane.CommPlane()
        counts = [0] * 50
        wires = [_Wire() for _ in counts]

        def bump(i):
            counts[i] += 1
            return i
        works = [_launch(plane, wire, then=lambda i=i: bump(i))
                 for i, wire in enumerate(wires)]
        errors = []

        def waiter():
            try:
                assert [w.result(timeout=30) for w in works] == \
                    list(range(50))
            except BaseException as e:  # noqa: BLE001 -- handed to the test thread
                errors.append(e)
        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=waiter) for _ in range(16)]
            for t in threads:
                t.start()
            for wire in wires:
                wire.land()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(prev)
        plane.drain(timeout=30)
        assert not errors and counts == [1] * 50
        assert all(wire.waits == 1 for wire in wires)
        assert plane.stats()["works"] == 50 and plane.pending_count() == 0

    def test_comm_counts_each_work_after_the_one_launched_before(self):
        """Works that land out of launch order (the backend runs two at
        once) count as the reference's one worker would run them, so one
        waiter draining in order never blocks longer than the comm. The
        plane meters on a clock the test moves (``CommPlane(clock=)``),
        so the host's load cannot move the readings."""
        clock = _FakeClock()
        plane = comm_plane.CommPlane(clock=clock)
        slow, fast = _Wire(), _Wire()
        _launch(plane, slow, label="slow")
        _launch(plane, fast, label="fast")
        clock.advance_ms(20)
        fast.land()                 # lands first: counts nothing
        clock.advance_ms(30)
        me = threading.get_ident()
        before = clock.reads[me]

        def land_once_drain_waits():
            # the drain's wait reads the clock once before it blocks
            while clock.reads[me] <= before:
                time.sleep(0.001)
            clock.advance_ms(20)
            slow.land()

        threading.Thread(target=land_once_drain_waits).start()
        plane.drain()
        st = plane.stats()
        assert 70 <= st["comm_ms"] < 1000
        assert 15 <= st["exposed_ms"] <= st["comm_ms"]

    def test_a_waited_work_leaves_the_pending_list(self):
        plane = comm_plane.CommPlane()
        first = _Wire()
        w = _launch(plane, first)
        first.land()
        w.wait()
        _launch(plane, _Wire())._work.land()
        assert plane.pending_count() == 1
        plane.drain()
        assert plane.pending_count() == 0

    def test_inline_work_is_all_exposed(self):
        plane = comm_plane.CommPlane()
        w = plane.run_inline(lambda: time.sleep(0.02) or 7, label="quant")
        assert w.is_completed() and w.result() == 7
        st = plane.stats()
        assert st["works"] == 1 and st["comm_ms"] >= 20
        assert st["exposed_ms"] == st["comm_ms"]
        assert st["overlap_efficiency"] == 0.0

    def test_prefetched_is_ordered(self):
        plane = comm_plane.CommPlane()
        starts, wires = [], {}

        def mk(i):
            def run():
                starts.append(i)
                if i % 2:               # odd thunks launch a collective
                    wires[i] = _Wire()
                    return _launch(plane, wires[i], then=lambda: i)
                return i
            return run
        got = []
        for value in comm_plane.prefetched([mk(i) for i in range(5)],
                                           depth=2):
            got.append(value)
            # the two thunks after the one yielded were started first
            assert starts == list(range(min(value + 3, 5)))
            for wire in wires.values():
                if not wire.fut.done():
                    wire.land()
        assert got == list(range(5))

    def test_the_pipeline_transport_waits_for_a7(self):
        """The stage-boundary transport is ported (the pipeline's slice);
        in a world of one process it refuses, naming what it needs (the
        messages themselves: ``tests/test_torch_pipeline_parallel.py``)."""
        import torch
        with pytest.raises(RuntimeError, match="init_parallel_env"):
            comm_plane.pp_send(torch.zeros(2), 1, "fwd", 0)
        with pytest.raises(RuntimeError, match="init_parallel_env"):
            comm_plane.pp_recv(0, "fwd", 0)


# -- the quantized wire's codec ---------------------------------------------
CODEC_CASES = [((1000,), 256, "int8", "float32"), ((7, 33), 32, "int8",
                                                    "float32"),
               ((5,), 8, "int8", "bfloat16"), ((300,), 64, "fp8_e4m3",
                                               "float32")]


@pytest.mark.parametrize("shape,bs,wire,scale", CODEC_CASES)
def test_codec_codes_and_scales_equal_the_reference(shape, bs, wire, scale):
    rng = np.random.default_rng(bs)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 100)).astype(
        np.float32)
    x.reshape(-1)[:bs] = 0.0          # an all-zero block: scale 0
    jq, js = jcq.quantize_blockwise(
        jnp.asarray(x), jcq.QuantConfig(wire, bs, scale))
    pq, ps = cq.quantize_blockwise(torch.from_numpy(x),
                                   cq.QuantConfig(wire, bs, scale))
    jq = np.asarray(jq.astype(jnp.float32))
    np.testing.assert_array_equal(pq.to(torch.float32).numpy(), jq)
    np.testing.assert_array_equal(ps.to(torch.float32).numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    assert float(ps[0]) == 0.0
    jround = np.asarray(jcq.quantization_roundtrip(
        jnp.asarray(x), jcq.QuantConfig(wire, bs, scale)))
    np.testing.assert_array_equal(cq.quantization_roundtrip(
        torch.from_numpy(x), cq.QuantConfig(wire, bs, scale)).numpy(),
        jround)
    assert cq.wire_nbytes(shape, cq.QuantConfig(wire, bs, scale)) == \
        jcq.wire_nbytes(shape, jcq.QuantConfig(wire, bs, scale))


def test_host_codec_reads_the_reference_messages():
    x = np.random.default_rng(3).standard_normal((4, 100)).astype(np.float32)
    msg = jcq.np_encode(x, jcq.QuantConfig(block_size=64))
    np.testing.assert_array_equal(cq.np_decode(msg), jcq.np_decode(msg))
    own = cq.np_encode(x, cq.QuantConfig(block_size=64))
    assert own["qdata"] == msg["qdata"] and own["scales"] == msg["scales"]


def test_error_feedback_keeps_the_residual():
    ef = cq.ErrorFeedback(cq.QuantConfig(block_size=4))
    g = torch.tensor([1.0, 0.01, -0.5, 0.3])
    first = ef.compensate("w", g)
    assert torch.equal(first, g)
    resid = ef._resid["w"]
    torch.testing.assert_close(
        resid, g - cq.quantization_roundtrip(g, ef._cfg), rtol=0, atol=0)
    assert torch.equal(ef.compensate("w", g), g + resid)


# -- DistributedBatchSampler -------------------------------------------------
class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n", [1, 7, 16, 33])
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_distributed_batch_sampler_equals_the_reference(n, batch, replicas):
    for rank in range(replicas):
        for shuffle in (False, True):
            for drop_last in (False, True):
                for epoch in (0, 5):
                    kw = dict(num_replicas=replicas, rank=rank,
                              shuffle=shuffle, drop_last=drop_last)
                    j = JSampler(_Sized(n), batch, **kw)
                    p = DistributedBatchSampler(_Sized(n), batch, **kw)
                    j.set_epoch(epoch)
                    p.set_epoch(epoch)
                    assert list(p) == list(j), (kw, epoch)
                    assert len(p) == len(j)


def test_distributed_batch_sampler_defaults_to_the_ports_world():
    dist.set_rank_world_size(1, 2)
    try:
        s = DistributedBatchSampler(_Sized(6), 2)
        assert (s.nranks, s.local_rank) == (2, 1)
        assert list(s) == [[1, 3], [5]]
    finally:
        dist.set_rank_world_size(None, None)


def test_gloo_refusing_cuda_tensors_names_the_op_and_backend(monkeypatch):
    from paddle_tpu_torch.distributed import collective

    class CudaLike:
        is_cuda = True

    def refuse():
        raise RuntimeError("unsupported device type")
    monkeypatch.setattr(collective, "get_backend", lambda group=None: "gloo")
    with pytest.raises(RuntimeError, match="reduce_scatter on CUDA tensors "
                                           "is refused by the gloo backend"):
        collective._run("reduce_scatter", None, [CudaLike()], refuse)
