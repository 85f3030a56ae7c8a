"""The rest of the port's training surface against the JAX package's, on
seeded numpy inputs:

- ``rms_norm`` and ``RMSNorm``: fp32 within 1e-6 (atol; outputs near 1);
  fp16 within one fp16 ulp of the outputs' largest magnitude (both
  compute in the input dtype and reduce in different orders);
- the tiny GPT with ``use_rmsnorm=True`` (``_torch_helpers``, 2 x 128
  tokens): the same parameter names, the loss within 1e-5 and every
  gradient within 2e-6 (the bounds of ``test_torch_train_step.py``), and
  three ``CompiledTrainStep`` AdamW steps at rtol 1e-5;
- ``Model.fit`` stepping an ``LRScheduler`` once per epoch, the
  ``LRScheduler`` callback (per batch) and ``ReduceLROnPlateau`` (a float
  rate cut after ``patience`` epochs; a scheduler left alone): the rates
  read at each batch or epoch equal JAX's exactly;
- ``LBFGS`` on a regularized least-squares problem, with and without the
  "strong_wolfe" search: the final loss at rtol 1e-5 and the weights
  within 1e-4 of JAX's (fp32, the same two-loop recursion in both; 15
  iterations leave both 2e-4 to 2.2e-3 from the fp64 optimum, and they
  differ by 1.2e-5 to 4.9e-5), each within 3e-3 of that optimum;
- the StepMeter: the metric names are the reference's (minus the
  straggler ones, which wait for the store, and the comm ones, which wait
  for a comm plane), one observation per step
  and per ``run_steps`` block, tokens/s equal to the step's tokens over
  its wall time, and the disabled and nested no-ops.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _torch_helpers import jax_state, tiny_models
from paddle_tpu.hapi.callbacks import Callback as JaxCallback
from paddle_tpu.jit.train_step import CompiledTrainStep as JaxTrainStep
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import perf as jperf
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi.callbacks import (Callback, LRScheduler,
                                             ReduceLROnPlateau)
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.observability import metrics as pmetrics
from paddle_tpu_torch.observability import perf as pperf
from paddle_tpu_torch.observability import trace as ptrace


@pytest.fixture(autouse=True)
def dense_jax_attention(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "0")


# -- RMSNorm ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(dtype)
    w = (1.0 + 0.1 * rng.standard_normal(16)).astype(dtype)
    ref = np.asarray(paddle.nn.functional.rms_norm(
        paddle.to_tensor(x), paddle.to_tensor(w))._value).astype(np.float32)
    got = PF.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else \
        2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 10)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)
    layer = pnn.RMSNorm(16, device="cpu")
    jlayer = paddle.nn.RMSNorm(16)
    assert [n for n, _ in layer.named_parameters()] == ["weight"]
    np.testing.assert_allclose(
        layer(torch.from_numpy(x.astype(np.float32))).detach().numpy(),
        np.asarray(jlayer(paddle.to_tensor(x.astype(np.float32)))._value),
        atol=1e-6, rtol=0)


def _batch(seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (2, 128) if k is None else (k, 2, 128)
    return rng.integers(0, 128, shape), rng.integers(0, 128, shape)


def test_rmsnorm_gpt_loss_and_gradients_match_jax():
    jm, pm = tiny_models(use_rmsnorm=True)
    assert sorted(n for n, _ in pm.named_parameters()) == \
        sorted(n for n, _ in jm.named_parameters())
    assert not any(n.endswith(("ln1.bias", "ln_f.bias"))
                   for n, _ in pm.named_parameters())
    jm.train()
    pm.train()
    ids, labels = _batch(0)
    _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    _, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(np.asarray(jloss._value)),
                               atol=1e-5, rtol=0)
    jgrads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], atol=2e-6,
                                   rtol=0, err_msg=n)


def test_rmsnorm_gpt_train_steps_match_jax():
    jm, pm = tiny_models(use_rmsnorm=True, seed=3)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    jstep = JaxTrainStep(lambda i, lb: jm(i, labels=lb)[1], jm, jopt,
                         donate=False)
    popt = port_opt.AdamW(learning_rate=1e-3, parameters=pm.parameters())
    pstep = CompiledTrainStep(lambda i, lb: pm(i, labels=lb)[1], pm, popt)
    for seed in range(3):
        ids, labels = _batch(20 + seed)
        jl = float(np.asarray(jstep(paddle.to_tensor(ids),
                                    paddle.to_tensor(labels))._value))
        pl = pstep(torch.from_numpy(ids), torch.from_numpy(labels)).item()
        np.testing.assert_allclose(pl, jl, rtol=1e-5)


# -- hapi: schedulers and their callbacks -------------------------------------
def _data(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            rng.integers(0, 3, (n,)).astype(np.int64))


def _lr_recorder(base, per="batch"):
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.lrs = []

        def on_train_batch_end(self, step, logs=None):
            if per == "batch":
                self.lrs.append(self.model._optimizer.get_lr())

        def on_epoch_end(self, epoch, logs=None):
            if per == "epoch":
                self.lrs.append(self.model._optimizer.get_lr())
    return Rec()


def _fit_lrs(make_lr, callbacks, epochs=3, per="batch"):
    """The rates read at each batch (or epoch) end of ``fit`` in each
    package, over a 4 -> 3 linear classifier with the same weights."""
    x, y = _data()
    out = {}
    paddle.seed(2)
    jnet = paddle.nn.Sequential(paddle.nn.Linear(4, 3))
    pnet = pnn.Sequential(pnn.Linear(4, 3, device="cpu"))
    load_jax_state(pnet, jax_state(jnet))
    for name in ("jax", "port"):
        if name == "jax":
            lr = make_lr(paddle.optimizer.lr)
            opt = paddle.optimizer.SGD(learning_rate=lr,
                                       parameters=jnet.parameters())
            rec = _lr_recorder(JaxCallback, per)
            cbs = [c(jax=True) for c in callbacks]
            model = paddle.Model(jnet).prepare(opt,
                                               paddle.nn.CrossEntropyLoss())
            data = paddle.io.DataLoader(paddle.io.TensorDataset([x, y]),
                                        batch_size=4, shuffle=False)
        else:
            lr = make_lr(port_opt.lr)
            opt = port_opt.SGD(learning_rate=lr,
                               parameters=pnet.parameters())
            rec = _lr_recorder(Callback, per)
            cbs = [c(jax=False) for c in callbacks]
            model = Model(pnet).prepare(opt, pnn.CrossEntropyLoss())
            data = TensorDataset([x, y])
        model.fit(data, batch_size=4, epochs=epochs, shuffle=False,
                  verbose=0, callbacks=cbs + [rec])
        out[name] = rec.lrs
    return out["jax"], out["port"]


def test_fit_steps_the_scheduler_once_per_epoch():
    jlrs, plrs = _fit_lrs(lambda m: m.StepDecay(0.1, step_size=1,
                                                gamma=0.5), [])
    assert plrs == jlrs == [0.1, 0.1, 0.05, 0.05, 0.025, 0.025]


def test_lr_scheduler_callback_steps_per_batch():
    def cb(jax):
        if jax:
            from paddle_tpu.hapi.callbacks import LRScheduler as J
            return J(by_step=True)
        return LRScheduler(by_step=True)
    jlrs, plrs = _fit_lrs(lambda m: m.StepDecay(0.1, step_size=1,
                                                gamma=0.5), [cb])
    # the callback steps before the recorder reads; fit adds one an epoch
    assert plrs == jlrs
    assert plrs[:3] == [0.05, 0.025, 0.00625]


@pytest.mark.parametrize("sched", [False, True], ids=["float", "scheduler"])
def test_reduce_lr_on_plateau_matches_jax(sched):
    def cb(jax):
        if jax:
            from paddle_tpu.hapi.callbacks import ReduceLROnPlateau as J
            return J(monitor="loss", factor=0.5, patience=1, min_lr=-1.0)
        return ReduceLROnPlateau(monitor="loss", factor=0.5, patience=1,
                                 min_lr=-1.0)
    # a negative rate climbs the loss, so no epoch improves on the first
    make = (lambda m: m.StepDecay(-0.5, step_size=100)) if sched \
        else (lambda m: -0.5)
    jlrs, plrs = _fit_lrs(make, [cb], epochs=4, per="epoch")
    assert plrs == jlrs
    if sched:
        assert plrs == [-0.5] * 4   # a scheduler's rate is left alone
    else:
        assert plrs == [-0.5, -0.25, -0.125, -0.0625]


# -- LBFGS --------------------------------------------------------------------
def _lbfgs(pkg, line_search):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((8, 5)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    w0 = rng.standard_normal((5,)).astype(np.float32)
    if pkg == "jax":
        w = paddle.create_parameter([5], "float32")
        w.set_value(w0)
        at, bt = paddle.to_tensor(a), paddle.to_tensor(b)
        opt = paddle.optimizer.LBFGS(learning_rate=0.5, max_iter=15,
                                     line_search_fn=line_search,
                                     parameters=[w])

        def closure():
            opt.clear_grad()
            r = paddle.matmul(at, w) - bt
            loss = 0.5 * (r * r).sum() + 0.1 * (w * w).sum()
            loss.backward()
            return loss
        loss = opt.step(closure)
        return loss, np.asarray(w._value)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    opt = port_opt.LBFGS(learning_rate=0.5, max_iter=15,
                         line_search_fn=line_search, parameters=[w])

    def closure():
        opt.clear_grad()
        r = at @ w - bt
        loss = 0.5 * (r * r).sum() + 0.1 * (w * w).sum()
        loss.backward()
        return loss
    loss = opt.step(closure)
    return loss, w.detach().numpy()


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    ploss, pw = _lbfgs("port", line_search)
    jloss, jw = _lbfgs("jax", line_search)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    np.testing.assert_allclose(pw, jw, atol=1e-4, rtol=0)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((8, 5))
    b = rng.standard_normal((8,))
    exact = np.linalg.solve(a.T @ a + 0.2 * np.eye(5), a.T @ b)
    np.testing.assert_allclose(pw, exact, atol=3e-3)
    with pytest.raises(ValueError):
        port_opt.LBFGS(parameters=[torch.nn.Parameter(torch.ones(1))],
                       line_search_fn="hager_zhang")


# -- the StepMeter ------------------------------------------------------------
def _perf_names(registry_snapshot):
    return {n for n in registry_snapshot["metrics"] if n.startswith("perf_")}


def test_step_meter_names_match_the_reference():
    for meter in (pperf.METER, jperf.METER):
        was = meter.enabled
        meter.enable()
        try:
            with meter.step(tokens=100, flops=1e9):
                pass
        finally:
            meter.enabled = was
    # the straggler detection waits for the store (its error counter is
    # the comm meters' too, which came with the comm plane)
    later = {"perf_straggler_detections_total", "perf_straggler_rank"}
    assert _perf_names(pmetrics.snapshot()) == \
        _perf_names(jmetrics.snapshot()) - later


def test_step_meter_accounts_each_step_and_block():
    _, pm = tiny_models()
    opt = port_opt.AdamW(learning_rate=1e-3, parameters=pm.parameters())
    step = CompiledTrainStep(lambda i, lb: pm(i, labels=lb)[1], pm, opt)
    assert step.set_meter_info(tokens_per_step=256,
                               flops_per_step=1e9) is step
    steps = pmetrics.counter("perf_steps_total")
    hist = pmetrics.histogram("perf_step_ms")
    n0 = steps.total()
    c0 = sum(s["count"] for s in hist.series().values()) \
        if hist.series() else 0
    ptrace.enable()
    ptrace.clear()
    pperf.enable()
    try:
        for seed in range(2):
            step(*map(torch.from_numpy, _batch(seed)))
        step.run_steps(*map(torch.from_numpy, _batch(7, k=2)))
    finally:
        pperf.disable()
        ptrace.disable()
    assert steps.total() - n0 == 3
    assert sum(s["count"] for s in hist.series().values()) - c0 == 3
    spans = [r for r in ptrace.TRACER.records() if r["name"] == "perf.step"]
    assert [s["attrs"]["kind"] for s in spans] == ["compiled", "compiled",
                                                   "compiled_block"]
    assert spans[-1]["attrs"]["k"] == 2
    for s, tokens in zip(spans, (256, 256, 512)):
        a = s["attrs"]
        assert a["tokens_per_sec"] == pytest.approx(
            tokens / (a["step_ms"] / 1e3), rel=1e-3)
        # rounded to 4 decimals, as in the reference
        assert a["achieved_tflops"] == pytest.approx(
            tokens / 256 * 1e9 / (a["step_ms"] / 1e3) / 1e12, rel=1e-3,
            abs=5e-5)
    assert pmetrics.gauge("perf_tokens_per_sec").series()[()] == \
        spans[-1]["attrs"]["tokens_per_sec"]


def test_step_meter_off_and_nested_are_no_ops():
    meter = pperf.StepMeter()
    meter.disable()
    assert meter.step(tokens=1) is pperf.NULL_STEP
    meter.enable()
    with meter.step(tokens=1) as outer:
        assert outer is not pperf.NULL_STEP
        assert meter.step(tokens=1) is pperf.NULL_STEP
    assert not pperf.enabled()
    with pytest.raises(NotImplementedError, match="A8"):
        pperf.configure_straggler(store=None, rank=0)
