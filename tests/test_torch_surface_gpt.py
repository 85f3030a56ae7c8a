"""GPT's eager dygraph loop written as an upstream user writes it, on
the ``paddle.*`` surface: ``paddle.seed``, ``to_tensor`` ids and labels,
``_, loss = model(ids, labels=labels)`` (a paddle Tensor),
``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``,
``float(loss)``. The tiny 2-layer GPT of ``_torch_helpers`` (hidden 128,
2 heads of 64, batches of 2 x 128 tokens: the plain K2/K3 on the CPU).

- Fed paddle Tensors, the port's loop is bit-equal to the same steps fed
  torch tensors: losses and every final parameter (the surface adds no
  arithmetic).
- Over 3 fp32 AdamW steps it is within 1e-4 (relative) of the
  reference's eager loop: every loss, and every parameter's change.
- A user's own ``paddle.nn.Layer`` gets paddle Tensors in ``forward``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as paddle
from _torch_helpers import tiny_models
from _torch_ops_sweep import on_cpu  # noqa: F401  (autouse fixture)
from paddle_tpu_torch import optimizer as popt

STEPS = 3


@pytest.fixture(autouse=True)
def dense_jax_attention(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "0")


def _batches():
    rng = np.random.default_rng(21)
    return [(rng.integers(0, 128, (2, 128)), rng.integers(0, 128, (2, 128)))
            for _ in range(STEPS)]


def _port_loop(surface):
    _, model = tiny_models(seed=3)
    model.train()
    opt = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    losses = []
    for ids, labels in _batches():
        if surface:
            ids, labels = paddle.to_tensor(ids), paddle.to_tensor(labels)
        else:
            ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)
        _, loss = model(ids, labels=labels)
        assert isinstance(loss, paddle.Tensor) == surface
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss) if surface else loss.item())
    return losses, model


def _reference_loop():
    jm, _ = tiny_models(seed=3)
    jm.train()
    opt = paddle_tpu.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=jm.parameters())
    losses = []
    for ids, labels in _batches():
        _, loss = jm(paddle_tpu.to_tensor(ids),
                     labels=paddle_tpu.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, jm


def test_surface_loop_is_bit_equal_to_the_torch_fed_loop():
    s_losses, s_model = _port_loop(surface=True)
    t_losses, t_model = _port_loop(surface=False)
    assert s_losses == t_losses
    for (name, a), b in zip(s_model.named_parameters(),
                            t_model.parameters()):
        assert torch.equal(a, b), name


def test_surface_loop_matches_the_reference():
    from _torch_helpers import jax_state
    p_losses, p_model = _port_loop(surface=True)
    j_losses, j_model = _reference_loop()
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)
    _, start = tiny_models(seed=3)
    j_final = jax_state(j_model)
    p_state = {n: p.detach().numpy() for n, p in p_model.named_parameters()}
    p_start = {n: p.detach().numpy() for n, p in start.named_parameters()}
    for name, now in p_state.items():
        dp = now - p_start[name]
        dj = j_final[name] - p_start[name]
        if name.endswith("qkv_proj.bias"):
            keep = np.r_[0:128, 256:384]   # the k third gets no gradient
            dp, dj = dp[keep], dj[keep]
        assert np.linalg.norm(dp - dj) <= 1e-4 * np.linalg.norm(dj), name

def test_user_layer_sees_paddle_tensors():
    class TwoLayer(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([4, 3])
            self.b = self.create_parameter([3], is_bias=True)
            self.seen = None

        def forward(self, x):
            self.seen = type(x)
            return paddle.tanh(paddle.matmul(x, self.w) + self.b).sum()

    paddle.seed(1)
    layer = TwoLayer()
    opt = popt.SGD(learning_rate=0.1, parameters=layer.parameters())
    x = paddle.to_tensor(np.linspace(-1, 1, 8, dtype=np.float32)
                         .reshape(2, 4))
    loss = layer(x)
    assert layer.seen is paddle.Tensor and isinstance(loss, paddle.Tensor)
    loss.backward()
    w = layer.w.detach().clone().requires_grad_()
    want = torch.autograd.grad(
        torch.tanh(torch.from_numpy(x.numpy()) @ w + layer.b.detach())
        .sum(), w)[0]
    torch.testing.assert_close(layer.w.grad, want, rtol=0, atol=0)
    opt.step()
    opt.clear_grad()
    assert float(layer(x)) < float(loss)
