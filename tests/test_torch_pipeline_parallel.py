"""The port's eager pipeline (``fleet/meta_parallel/{pp_layers,
pipeline_parallel}.py``, ``autograd.deferred_leaf_grads``, the comm
plane's ``pp_send``/``pp_recv``) against the JAX package's.

In one process, on the reference's bottleneck model (Linear 8->4, Tanh,
Linear 4->8 per stage, an MSE loss) with the reference's weights carried
across as numpy:

- the stage bounds, the schedule strings and ``_last_schedule`` and
  ``_last_max_inflight`` of all three modes at pp 2 and 4 (the
  reference's single-process ``_FakeHcg`` pattern), the split and spec
  errors by type and text, and ``shard_to_stage``'s refusals;
- ``_local_train``'s losses and post-step parameters over two SGD steps
  against the reference's, in every mode (fp32: within 1e-6 of the
  largest entry), and every mode bit-identical to plain accumulation in
  the port;
- ``deferred_leaf_grads``: after ``flush()`` the gradients are
  bit-equal to a plain ``backward()`` on a graph where one leaf takes
  several contributions (grad-ready hooks fire at the flush, in walk
  order); without ``flush()`` nothing lands; ``eval_batch`` both ways
  against the reference (1e-6).

Across two gloo ranks on the CPU (launched once for the file,
``fleet.init`` at pp 2): ``fleet.distributed_model`` returns a
``PipelineParallel``; each schedule's two steps are bit-identical to
``_local_train`` of the same microbatches in the same process (losses on
both ranks, each stage's parameters); each rank's ``_last_schedule`` has
the reference's multi-process shape; ``eval_batch`` equals the one-process
mean bit for bit; a planted wrong tag raises ``PipelineWireMismatch``
and a drifting boundary shape ``PipelineSpecMismatch``, with the
reference's texts; a send to a peer that has not posted its receive
returns at once, for 64 B and for a 3 MB tensor.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JLayerDesc, MicroBatchSplitError as JSplitError,
    PipelineLayer as JPipelineLayer, PipelineParallel as JPipelineParallel,
    PipelineSpecMismatch as JSpecMismatch, SharedLayerDesc as JShared)

from _torch_hybrid_helpers import assert_check, run_ranks
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.autograd import tape as ttape
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, MicroBatchSplitError, PipelineLayer, PipelineParallel,
    PipelineSpecMismatch, SharedLayerDesc)
from paddle_tpu_torch.optimizer import SGD

TOL = 1e-6
MODES = ("1f1b", "zero_bubble", "gpipe")


def _mse(out, y):
    return ((out - y) * (out - y)).mean()


class _FakeHcg:
    """One process standing in for pp stages (the reference's test
    helper): the pipeline runs ``_local_train``."""

    def __init__(self, pp, stage=0):
        self._pp, self._stage = pp, stage

    def get_pipe_parallel_world_size(self):
        return self._pp

    def get_stage_id(self):
        return self._stage

    def get_pipe_parallel_group(self):
        return SimpleNamespace(ranks=list(range(self._pp)))


def _strategy(m, mode):
    return SimpleNamespace(pipeline_configs={
        "micro_batch_size": 2, "accumulate_steps": m, "schedule_mode": mode})


def _jax_model(pp):
    paddle.seed(0)
    descs = []
    for _ in range(pp):
        descs += [JLayerDesc(jnn.Linear, 8, 4), JLayerDesc(jnn.Tanh),
                  JLayerDesc(jnn.Linear, 4, 8)]
    return JPipelineLayer(descs, num_stages=pp, loss_fn=_mse)


def _port_model(pp, state=None):
    descs = []
    for _ in range(pp):
        descs += [LayerDesc(tnn.Linear, 8, 4, device="cpu"),
                  LayerDesc(tnn.Tanh),
                  LayerDesc(tnn.Linear, 4, 8, device="cpu")]
    model = PipelineLayer(descs, num_stages=pp, loss_fn=_mse)
    if state is not None:
        load_jax_state(model, state)
    return model


def _state(jmodel):
    return {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}


def _pair(pp, m, mode):
    """The reference's pipeline and the port's, on the same weights."""
    jm = _jax_model(pp)
    jp = JPipelineParallel(jm, _FakeHcg(pp), _strategy(m, mode))
    tp = PipelineParallel(_port_model(pp, _state(jm)), _FakeHcg(pp),
                          _strategy(m, mode))
    return jp, tp


def _batch(m, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(m * 2, 8).astype("float32"),
            rs.randn(m * 2, 8).astype("float32"))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("n,stages", [(6, 2), (7, 3), (12, 4), (5, 4),
                                      (3, 1)])
def test_stage_bounds_match_reference(n, stages):
    j = JPipelineLayer([JLayerDesc(jnn.Tanh) for _ in range(n)],
                       num_stages=stages)
    t = PipelineLayer([LayerDesc(tnn.Tanh) for _ in range(n)],
                      num_stages=stages)
    assert t._stage_bounds == j._stage_bounds
    for s in range(stages):
        assert len(t.get_stage_layers(s)) == len(j.get_stage_layers(s))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pp,m", [(2, 4), (2, 8), (4, 4), (4, 8)])
def test_schedule_matches_reference(pp, m, mode):
    jp, tp = _pair(pp, m, mode)
    x, y = _batch(m)
    jp.train_batch((paddle.to_tensor(x), paddle.to_tensor(y)),
                   paddle.optimizer.SGD(learning_rate=0.05,
                                        parameters=jp.parameters()))
    tp.train_batch((torch.tensor(x), torch.tensor(y)),
                   SGD(learning_rate=0.05, parameters=tp.parameters()))
    assert tp._schedule_mode == jp._schedule_mode
    assert tp._last_schedule == jp._last_schedule
    assert tp._last_max_inflight == jp._last_max_inflight


def test_schedule_aliases_and_unknown_mode_match_reference():
    for alias in ("zb", "ZBH1", "f-then-b", "1F1B", "gpipe"):
        jp, tp = _pair(2, 2, alias)
        assert tp._schedule_mode == jp._schedule_mode
    with pytest.raises(ValueError) as je:
        _pair(2, 2, "interleaved-magic")
    with pytest.raises(ValueError) as te:
        PipelineParallel(_port_model(2), _FakeHcg(2),
                         _strategy(2, "interleaved-magic"))
    assert str(te.value) == str(je.value)


def test_split_and_spec_errors_match_reference():
    jp, tp = _pair(2, 4, "1f1b")
    with pytest.raises(JSplitError) as je:
        jp._split_micro(paddle.to_tensor(np.zeros((10, 8), np.float32)))
    with pytest.raises(MicroBatchSplitError) as te:
        tp._split_micro(torch.zeros(10, 8))
    assert str(te.value) == str(je.value)
    assert tp._split_micro(None) == [None] * 4
    assert [tuple(p.shape) for p in tp._split_micro(torch.zeros(8, 8))] \
        == [(2, 8)] * 4
    for p in (jp, tp):
        p._agree_spec("in", (4, 8), "float32")
        p._agree_spec("in", (4, 8), "float32")
    with pytest.raises(JSpecMismatch) as je:
        jp._agree_spec("in", (4, 16), "float32")
    with pytest.raises(PipelineSpecMismatch) as te:
        tp._agree_spec("in", (4, 16), "float32")
    assert str(te.value) == str(je.value)


def test_shard_to_stage_keeps_the_stage_and_refuses_as_the_reference():
    whole = _port_model(2, _state(_jax_model(2)))
    model = _port_model(2, _state(_jax_model(2)))
    model.shard_to_stage(1)
    model.shard_to_stage(1)                  # idempotent
    want = [p for layer, _ in whole.get_stage_layers(1)
            for p in layer.parameters()]
    got = list(model.parameters())
    assert len(got) == len(want) == 4
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(RuntimeError, match="cannot re-shard to 0"):
        model.shard_to_stage(0)
    j = JPipelineLayer([JShared("emb", jnn.Linear, None, "weight", 4, 4),
                        JLayerDesc(jnn.Tanh)], num_stages=2)
    t = PipelineLayer([SharedLayerDesc("emb", tnn.Linear, None, "weight",
                                       4, 4, device="cpu"),
                       LayerDesc(tnn.Tanh)], num_stages=2)
    with pytest.raises(NotImplementedError) as je:
        j.shard_to_stage(0)
    with pytest.raises(NotImplementedError) as te:
        t.shard_to_stage(0)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("mode", MODES)
def test_local_train_matches_reference(mode):
    m = 4
    jp, tp = _pair(2, m, mode)
    jopt = paddle.optimizer.SGD(learning_rate=0.05,
                                parameters=jp.parameters())
    topt = SGD(learning_rate=0.05, parameters=tp.parameters())
    for seed in (0, 1):
        x, y = _batch(m, seed)
        jl = jp.train_batch((paddle.to_tensor(x), paddle.to_tensor(y)), jopt)
        tl = tp.train_batch((torch.tensor(x), torch.tensor(y)), topt)
        assert abs(float(tl) - float(jl.numpy())) <= TOL * abs(
            float(jl.numpy()))
    jstate = _state(jp._layers)
    for name, p in tp._layers.state_dict().items():
        assert _rel(p.numpy(), jstate[name]) <= TOL, name


def test_every_mode_bit_identical_to_plain_accumulation():
    m = 4
    x, y = (torch.tensor(a) for a in _batch(m))
    state = _state(_jax_model(2))
    base = _port_model(2, state)
    opt = SGD(learning_rate=0.05, parameters=base.parameters())
    total = None
    for xk, yk in zip(x.split(2), y.split(2)):
        loss = _mse(base(xk), yk)
        total = loss.detach() if total is None else total + loss.detach()
        (loss * (1.0 / m)).backward()
    opt.step()
    want = (total * (1.0 / m), [p.detach().clone()
                                for p in base.parameters()])
    for mode in MODES:
        pipe = PipelineParallel(_port_model(2, state), _FakeHcg(2),
                                _strategy(m, mode))
        got = pipe.train_batch((x, y), SGD(learning_rate=0.05,
                                           parameters=pipe.parameters()))
        assert torch.equal(got, want[0]), mode
        for p, w in zip(pipe._layers.parameters(), want[1]):
            assert torch.equal(p, w), mode


def test_train_batch_reads_nothing_back(monkeypatch):
    """The loss accumulates on the device: no ``item``, ``tolist``,
    ``numpy`` or ``float`` inside ``train_batch``."""
    calls = []
    for name in ("item", "tolist", "numpy", "__float__"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _real=real, _n=name, **k:
            calls.append(_n) or _real(self, *a, **k))
    _, tp = _pair(2, 4, "zero_bubble")
    x, y = (torch.tensor(a) for a in _batch(4))
    loss = tp.train_batch((x, y), SGD(learning_rate=0.05,
                                      parameters=tp.parameters()))
    assert calls == []
    float(loss)
    assert calls == ["__float__"]


def test_eval_batch_matches_reference():
    jp, tp = _pair(2, 4, "1f1b")
    x, y = _batch(4)
    jl = jp.eval_batch((paddle.to_tensor(x), paddle.to_tensor(y)))
    tl = tp.eval_batch((torch.tensor(x), torch.tensor(y)))
    assert _rel(tl.numpy(), jl.numpy()) <= TOL
    jo = jp.eval_batch((paddle.to_tensor(x), paddle.to_tensor(y)),
                       compute_loss=False)
    to = tp.eval_batch((torch.tensor(x), torch.tensor(y)),
                       compute_loss=False)
    assert tuple(to.shape) == (8, 8)
    assert _rel(to.numpy(), jo.numpy()) <= TOL


def _graph():
    """A net whose weight ``w`` takes three contributions."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn(6, 3, generator=g, requires_grad=True)
    b = torch.randn(3, generator=g, requires_grad=True)
    x = torch.randn(4, 6, generator=g, requires_grad=True)

    def loss():
        h = torch.tanh(x @ w + b)
        return (h * h).mean() + (x @ w).sum() * 0.1 + (w * w).sum()
    return w, b, x, loss


def test_deferred_leaf_grads_bit_equal_after_flush():
    w, b, x, loss = _graph()
    loss().backward()
    want = [t.grad.clone() for t in (w, b, x)]
    w, b, x, loss = _graph()
    fired = []
    for name, t in (("w", w), ("b", b), ("x", x)):
        ttape.register_grad_ready_hook(t, lambda _, n=name: fired.append(n))
    params = {id(w), id(b)}
    with ttape.deferred_leaf_grads(lambda t: id(t) in params) as d:
        ttape.backward(loss())
        assert w.grad is None and b.grad is None
        assert d.deferred_count() == 2
        assert fired == ["x"]          # the input accumulated mid-walk
    assert w.grad is None              # leaving the context does not flush
    d.flush()
    assert sorted(fired[1:]) == ["b", "w"]
    for t, g in zip((w, b, x), want):
        assert torch.equal(t.grad, g)


def test_deferred_leaf_grads_dropped_without_flush():
    w, b, x, loss = _graph()
    with ttape.deferred_leaf_grads(lambda t: t is w) as d:
        ttape.backward(loss())
    assert d.deferred_count() == 1
    assert w.grad is None and b.grad is not None
    del d
    assert w.grad is None


# -- two gloo ranks -----------------------------------------------------------
_WORKER = """
import time
from types import SimpleNamespace
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import comm_plane as cp
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel, PipelineSpecMismatch)
from paddle_tpu_torch.optimizer import SGD

STAGE = MESH.coord["pp"]
PP_GROUP = MESH.group("pp")
M = 4


def mse(o, y):
    return ((o - y) * (o - y)).mean()


def build():
    torch.manual_seed(0)
    descs = []
    for _ in range(2):
        descs += [LayerDesc(tnn.Linear, 8, 4, device="cpu"),
                  LayerDesc(tnn.Tanh),
                  LayerDesc(tnn.Linear, 4, 8, device="cpu")]
    return PipelineLayer(descs, num_stages=2, loss_fn=mse)


class OneProcess:
    def get_pipe_parallel_world_size(self):
        return 2

    def get_stage_id(self):
        return 0

    def get_pipe_parallel_group(self):
        return SimpleNamespace(ranks=[0, 0])


rs = np.random.RandomState(0)
batches = [(torch.tensor(rs.randn(8, 8).astype("float32")),
            torch.tensor(rs.randn(8, 8).astype("float32")))
           for _ in range(2)]
assert MESH.shape["pp"] == 2 and STAGE == RANK
ok("mesh")
schedules = {}
for mode in ("1f1b", "zero_bubble", "gpipe"):
    strategy = fleet.get_strategy()
    strategy.pipeline_configs = {"accumulate_steps": M,
                                 "micro_batch_size": 2,
                                 "schedule_mode": mode}
    local = PipelineParallel(build(), OneProcess(), strategy)
    lopt = SGD(learning_rate=0.05, parameters=local.parameters())
    want = [local.train_batch(b, lopt) for b in batches]
    pipe = fleet.distributed_model(build())
    assert type(pipe) is PipelineParallel and pipe._multi
    opt = SGD(learning_rate=0.05, parameters=pipe.parameters())
    got = [pipe.train_batch(b, opt) for b in batches]
    assert all(torch.equal(a, b) for a, b in zip(got, want)), (got, want)
    mine = [p for layer, _ in local._layers.get_stage_layers(STAGE)
            for p in layer.parameters()]
    theirs = list(pipe._layers.parameters())
    assert len(mine) == len(theirs) == 4
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    schedules[mode] = [list(e) for e in pipe._last_schedule] + [
        pipe._last_max_inflight]
    ok(mode)
    if mode == "1f1b":
        # eval across the stages: the one-process mean, bit for bit
        got = pipe.eval_batch(batches[0])
        assert torch.equal(got, local.eval_batch(batches[0])), got
        out = pipe.eval_batch(batches[0], compute_loss=False)
        if STAGE == 1:
            with torch.no_grad():
                want = torch.cat([local._layers(xk)
                                  for xk in batches[0][0].split(2)])
            assert torch.equal(out, want)
        else:
            assert out is None
        ok("eval")
print("SCHEDULES " + json.dumps(schedules), flush=True)

# a planted wrong tag, then a drifting boundary shape: stage 0 sends by
# hand, stage 1 runs its eval schedule (whose first receive is mb 0)
msgs = {}
if STAGE == 0:
    cp.pp_send(torch.zeros(2, 8), 1, "fwd", 5, group=PP_GROUP).wait()
    cp.pp_send(torch.zeros(2, 16), 1, "fwd", 0, group=PP_GROUP).wait()
else:
    try:
        pipe.eval_batch(batches[0])
    except cp.PipelineWireMismatch as e:
        msgs["wire"] = str(e)
    try:
        pipe.eval_batch(batches[0])
    except PipelineSpecMismatch as e:
        msgs["spec"] = str(e)
    assert set(msgs) == {"wire", "spec"}, msgs
print("MESSAGES " + json.dumps(msgs), flush=True)
ok("mismatches")

# a send to a peer that has not posted its receive returns at once
for n in (16, 786432):
    x = torch.arange(n, dtype=torch.float32)
    if STAGE == 0:
        t0 = time.perf_counter()
        work = cp.pp_send(x, 1, "fwd", 0, group=PP_GROUP)
        took = time.perf_counter() - t0
        assert took < 0.5, took
        work.wait()
        print(f"SEND {n * 4} {took}", flush=True)
    else:
        time.sleep(1.0)
        got = cp.pp_recv(0, "fwd", 0, group=PP_GROUP).result()
        assert torch.equal(got, x)
    dist.barrier()
ok("send_before_receive")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_parallel")
    return run_ranks(tmp, _WORKER, {"dp_degree": 1, "pp_degree": 2})


def _tagged(logs, tag):
    return {r: json.loads(next(line[len(tag) + 1:] for line in
                               logs[f"workerlog.{r}"].splitlines()
                               if line.startswith(tag + " ")))
            for r in range(2)}


def test_fleet_builds_the_pp_mesh_and_a_pipeline(ranks):
    assert_check(ranks, "mesh")


@pytest.mark.parametrize("mode", MODES)
def test_schedule_across_processes_bit_equal_to_local_train(ranks, mode):
    assert_check(ranks, mode)


def _multi_process_schedule(pp, stage, m, mode):
    """The reference's multi-process order for ``stage``."""
    warmup = m if mode == "gpipe" else min(pp - 1 - stage, m)
    out, queue = [], []
    for k in range(warmup):
        out.append(("F", k))
        queue.append(k)
    bwd = ([("B", None), ("W", None)] if mode == "zero_bubble"
           else [("B", None)])
    for k in range(warmup, m):
        out.append(("F", k))
        queue.append(k)
        j = queue.pop(0)
        out += [(op, j) for op, _ in bwd]
    while queue:
        j = queue.pop(0)
        out += [(op, j) for op, _ in bwd]
    return out


@pytest.mark.parametrize("mode", MODES)
def test_schedule_across_processes_has_the_reference_shape(ranks, mode):
    got = _tagged(ranks, "SCHEDULES")
    for stage in range(2):
        sched = [tuple(e) for e in got[stage][mode][:-1]]
        assert sched == _multi_process_schedule(2, stage, 4, mode)
        inflight = got[stage][mode][-1]
        assert inflight == (4 if mode == "gpipe" else 2 - stage)


def test_eval_batch_across_processes(ranks):
    assert_check(ranks, "eval")


def test_wire_and_spec_mismatches_raise_with_the_reference_text(ranks):
    assert_check(ranks, "mismatches")
    msgs = _tagged(ranks, "MESSAGES")[1]
    assert msgs["wire"] == (
        "pp.recv expected ('fwd', mb=0) from rank 0 but popped tag "
        "('fwd', 5): stage schedules diverged")
    assert msgs["spec"] == (
        "stage 1 in-boundary expects shape=(2, 8) dtype=float32 but "
        "saw shape=(2, 16) dtype=float32: boundary specs are agreed "
        "once at wiring time, not per-send")


def test_send_before_receive_does_not_block(ranks):
    assert_check(ranks, "send_before_receive")
    sends = [line.split() for line in ranks["workerlog.0"].splitlines()
             if line.startswith("SEND ")]
    assert [int(s[1]) for s in sends] == [64, 3145728]
