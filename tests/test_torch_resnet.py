"""The port's ResNet (``paddle_tpu_torch/vision/models/resnet.py``) against
the JAX package's, the port loaded with the JAX model's weights and
running statistics, in fp32, and the port's channels-last model against
its NCHW one.

- ResNet-18, 4 x 3 x 64 x 64, 10 classes, one training forward and
  backward: the loss within 1e-5 of its value, each gradient within 1e-4
  of its own largest entry, the running statistics after it within 1e-4
  of each statistic's largest entry; then, both models given the same
  statistics, an eval forward's logits within 1e-5 of their largest
  entry.
- ResNet-50, 10 classes: a training forward at 2 x 3 x 224 x 224 (loss,
  running statistics), an eval forward of it (same bounds), and, in eval
  mode, every gradient at 2 x 3 x 64 x 64 (1e-4 of its own largest
  entry).

Why ResNet-50's *training-mode* gradients are not compared, and why
ResNet-18's are compared on one draw and held to fp64 on another: at
random initialization the backward through the batch norms' batch
statistics cancels most of each gradient (it grows ~100x from the last
stage to the first), so fp32 determines it poorly. On the CPU, for
ResNet-50 at 2 x 224 x 224 and 2 x 64 x 64, the port's fp32 gradients
differ from its fp64 ones by 2.3e-2 of the model's largest entry, 159 of
161 tensors by more than 1e-4 of their own. For ResNet-18 the port's
stay within 1.1e-5 of fp64 on every draw tried but one, while the JAX
package's batch-norm VJP (one pass over x shifted by one sample,
``paddle_tpu/nn/functional/norm.py:85-113``) is 4e-2 to 1.5e-1 of the
largest entry away on 4 of 6 draws (ROADMAP C); on the draw below (seed
0) both are within 2.6e-5. With the batch norms on their running
statistics the backward is well conditioned (2e-6 against fp64).
The running statistics' bound: the JAX package's one-pass shifted
variance is itself 2.8e-5 of the largest entry away from the fp64
statistics at ResNet-50's last stage (the port's 1.5e-5).

Each JAX model is built and run once per module: building ResNet-50
and its eager passes take seconds on the CPU.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _torch_helpers import jax_state
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.vision import models


def _np(t):
    return np.asarray(t._value)


def _images(seed, n, size=64, k=None, classes=10):
    rng = np.random.default_rng(seed)
    lead = (n,) if k is None else (k, n)
    return (rng.uniform(0, 1, lead + (3, size, size)).astype(np.float32),
            rng.integers(0, classes, lead))


def _pair(depth, seed=0, **kw):
    """The same ResNet in both packages (10 classes), the port loaded with
    the JAX model's state."""
    from paddle_tpu.vision import models as jmodels
    paddle.seed(seed)
    jm = getattr(jmodels, f"resnet{depth}")(num_classes=10, **kw)
    pm = getattr(models, f"resnet{depth}")(num_classes=10, device="cpu",
                                           **kw)
    load_jax_state(pm, jax_state(jm))
    return jm, pm


def _stats(model):
    """{name: a numpy copy of each running statistic}."""
    return {n: (_np(b) if hasattr(b, "_value") else b.numpy().copy())
            for n, b in model.named_buffers()}


def _loss_and_grads(jm, pm, x, y):
    jloss = paddle.nn.CrossEntropyLoss()(jm(paddle.to_tensor(x)),
                                         paddle.to_tensor(y))
    jloss.backward()
    ploss = pnn.CrossEntropyLoss()(pm(torch.from_numpy(x)),
                                   torch.from_numpy(y))
    ploss.backward()
    return ((float(_np(jloss)), float(ploss.detach())),
            ({k: _np(p.grad) for k, p in jm.named_parameters()},
             {k: p.grad.numpy() for k, p in pm.named_parameters()}))


def _eval_forward(jm, pm, x):
    """Both models in eval mode on the JAX model's running statistics
    (the training step left them a few ulps apart), and their logits."""
    load_jax_state(pm, jax_state(jm))
    jm.eval()
    pm.eval()
    with torch.no_grad():
        return (_np(jm(paddle.to_tensor(x))),
                pm(torch.from_numpy(x)).numpy())


@pytest.fixture(scope="module")
def resnet18_step():
    """ResNet-18, one training forward and backward at 4 x 3 x 64 x 64,
    then an eval forward of the same images."""
    jm, pm = _pair(18)
    x, y = _images(18, 4)
    out = dict(zip(("loss", "grads"), _loss_and_grads(jm, pm, x, y)))
    out["stats"] = _stats(jm), _stats(pm)
    out["eval"] = _eval_forward(jm, pm, x)
    return out


@pytest.fixture(scope="module")
def resnet50_step():
    """ResNet-50: a training forward at 2 x 3 x 224 x 224 (the loss and
    the running statistics it leaves), an eval forward of the same images,
    then, in eval mode, the loss and every gradient at 2 x 3 x 64 x 64."""
    jm, pm = _pair(50)
    x, y = _images(50, 2, size=224)
    with torch.no_grad():
        out = {"loss": (float(_np(paddle.nn.CrossEntropyLoss()(
            jm(paddle.to_tensor(x)), paddle.to_tensor(y)))),
            float(pnn.CrossEntropyLoss()(pm(torch.from_numpy(x)),
                                         torch.from_numpy(y))))}
    out["stats"] = _stats(jm), _stats(pm)
    out["eval"] = _eval_forward(jm, pm, x)
    x, y = _images(51, 2)
    _, out["grads"] = _loss_and_grads(jm, pm, x, y)
    return out


@pytest.fixture(params=["resnet18", "resnet50"])
def stepped(request):
    return request.getfixturevalue(f"{request.param}_step")


def test_fp32_loss_matches_jax(stepped):
    want, got = stepped["loss"]
    assert abs(got - want) <= 1e-5 * abs(want)


def test_fp32_gradients_match_jax(stepped):
    jgrads, pgrads = stepped["grads"]
    assert sorted(pgrads) == sorted(jgrads)
    for name, g in pgrads.items():
        top = float(np.abs(jgrads[name]).max())
        err = float(np.abs(g - jgrads[name]).max())
        assert err <= 1e-4 * top, (name, err, top)


def test_fp32_running_statistics_match_jax(stepped):
    jstats, pstats = stepped["stats"]
    assert sorted(pstats) == sorted(jstats)
    for name, v in pstats.items():
        assert v.dtype == np.float32
        top = float(np.abs(jstats[name]).max())
        np.testing.assert_allclose(v, jstats[name], atol=1e-4 * top,
                                   rtol=0, err_msg=name)


def test_fp32_eval_forward_matches_jax(stepped):
    want, got = stepped["eval"]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


def test_channels_last_equals_nchw():
    ref = models.resnet18(num_classes=10, device="cpu", seed=1)
    nhwc = models.resnet18(num_classes=10, device="cpu", seed=1,
                           data_format="NHWC")
    assert sorted(ref.state_dict()) == sorted(nhwc.state_dict())
    x, y = _images(5, 4)
    losses = []
    for m in (ref, nhwc):
        loss = pnn.CrossEntropyLoss()(m(torch.from_numpy(x)),
                                      torch.from_numpy(y))
        loss.backward()
        losses.append(float(loss))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    grads = dict(nhwc.named_parameters())
    for name, p in ref.named_parameters():
        top = float(p.grad.abs().max())
        assert float((grads[name].grad - p.grad).abs().max()) <= 1e-4 * top
    for name, b in ref.named_buffers():
        torch.testing.assert_close(dict(nhwc.named_buffers())[name], b,
                                   atol=1e-5, rtol=1e-5)


def test_resnet18_training_gradients_hold_to_fp64():
    """A draw (weights seed 2, images seed 7) on which the JAX package's
    fp32 batch-norm backward is 4e-2 of the largest entry off fp64: the
    port's gradients stay within 1e-4 of each one's largest entry of the
    same model's fp64 gradients."""
    import copy
    _, pm = _pair(18, seed=2)
    pd = copy.deepcopy(pm).double()
    x, y = _images(7, 4)
    grads = []
    for m, dt in ((pm, torch.float32), (pd, torch.float64)):
        pnn.CrossEntropyLoss()(m(torch.from_numpy(x).to(dt)),
                               torch.from_numpy(y)).backward()
        grads.append(dict(m.named_parameters()))
    for name, p in grads[1].items():
        top = float(p.grad.abs().max())
        err = float((grads[0][name].grad.double() - p.grad).abs().max())
        assert err <= 1e-4 * top, (name, err, top)
