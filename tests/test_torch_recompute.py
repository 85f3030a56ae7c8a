"""Recompute of the port (``fleet/utils/recompute.py``,
``fleet.utils.recompute_sequential``, ``recompute_hybrid``), in one
process: with dropout on, the recomputed block draws the same masks in
the backward as in the forward, so every gradient equals the plain
run's, for torch tensors and paddle Tensors, reentrant or not. The
dropouts are the port's layer (PyTorch's generator) and its random op
(the port's own generator); both are replayed.

The plain run starts from the same generator states, so outputs and
gradients must be bit-equal.
"""
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.distributed.fleet import utils as futils
from paddle_tpu_torch.framework import place as port_place
from paddle_tpu_torch.framework import random as prandom


@pytest.fixture(autouse=True)
def on_cpu():
    """The random op's place is the CPU for the test."""
    prev = port_place._current_place
    port_place.set_device("cpu")
    yield
    port_place._current_place = prev


class Block(torch.nn.Module):
    def __init__(self, g):
        super().__init__()
        self.fc1 = pnn.Linear(16, 32, device="cpu", generator=g)
        self.fc2 = pnn.Linear(32, 16, device="cpu", generator=g)
        self.drop = pnn.Dropout(0.5)

    def forward(self, x):
        h = self.drop(torch.tanh(self.fc1(x)))
        # a mask drawn from the port's own generator as well
        keep = (paddle.rand([h.shape[-1]])._value >= 0.3).to(h.dtype)
        return self.fc2(h * keep)


def _build():
    g = torch.Generator().manual_seed(0)
    return torch.nn.Sequential(Block(g), Block(g), Block(g))


def _seed():
    torch.manual_seed(123)
    prandom.seed(321)


def _grads(net, x, run):
    _seed()
    xr = x.clone().requires_grad_(True)
    y = run(net, xr)
    y = getattr(y, "_value", y)
    (y * torch.arange(y.numel()).reshape(y.shape)).sum().backward()
    out = [y.detach(), xr.grad] + [p.grad.clone() for p in net.parameters()]
    net.zero_grad()
    return out


@pytest.mark.parametrize("reentrant", [True, False])
@pytest.mark.parametrize("how", ["recompute", "sequential", "segments",
                                 "hybrid", "surface"])
def test_recompute_gradients_equal_plain(how, reentrant):
    net = _build()
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    want = _grads(net, x, lambda n, t: n(t))

    def run(n, t):
        kw = {"use_reentrant": reentrant}
        if how == "recompute":
            for blk in n:
                t = futils.recompute(blk, t, **kw)
            return t
        if how == "sequential":
            return futils.recompute_sequential({}, n, t, **kw)
        if how == "segments":
            return futils.recompute_sequential({"segments": 2}, n, t, **kw)
        if how == "hybrid":
            return futils.recompute_hybrid({}, n, t, **kw)
        # a function of paddle Tensors: its argument and result wrap
        return futils.recompute(
            lambda v: paddle.Tensor._wrap(n(v._value)),
            paddle.Tensor._wrap(t), **kw)

    got = _grads(net, x, run)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_recompute_without_grad_runs_the_function():
    net = _build()
    x = torch.randn(4, 16)
    with torch.no_grad():
        _seed()
        a = futils.recompute(net, x)
        _seed()
        b = net(x)
    assert torch.equal(a, b)


def test_rng_states_left_as_a_plain_run_leaves_them():
    net = _build()
    x = torch.randn(4, 16)
    _grads(net, x, lambda n, t: futils.recompute(n, t))
    after = (torch.get_rng_state(),
             prandom.generator(torch.device("cpu")).get_state())
    _grads(net, x, lambda n, t: n(t))
    plain = (torch.get_rng_state(),
             prandom.generator(torch.device("cpu")).get_state())
    assert all(torch.equal(a, b) for a, b in zip(after, plain))
