"""The port's ``Precision``, ``Recall``, ``Auc`` and ``accuracy``
(``paddle_tpu_torch/metric``), ``paddle.summary`` and ``paddle.flops``
(``hapi/``) and ``utils.dlpack`` against the JAX package's.

- The metrics on the same seeded batches (a few updates each, both
  thresholds' sides populated) within 1e-7 of the reference: the counts
  are integers, and ``Auc`` integrates the same buckets by the same rule.
- ``summary`` prints the same table and returns the same totals, and
  ``flops`` returns the same count and detail, on LeNet and ResNet-18.
- DLPack: the port's tensors round trip through capsules, a NumPy array
  and a raw capsule (host memory) come in without a copy, and tensors
  cross between the packages through capsules in both directions.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from _torch_helpers import jax_state
from _torch_ops_sweep import on_cpu  # noqa: F401  (autouse: the CPU place)
from paddle_tpu.utils import dlpack as jdlpack
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.utils import dlpack
from paddle_tpu_torch.vision import models


def _batches(seed, n=3, rows=257):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.random(rows).astype(np.float32),
               rng.integers(0, 2, rows).astype(np.int64))


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_the_reference(name):
    port, ref = getattr(paddle.metric, name)(), \
        getattr(jpaddle.metric, name)()
    assert port.name() == ref.name()
    for preds, labels in _batches(1):
        port.update(torch.from_numpy(preds), torch.from_numpy(labels))
        ref.update(jpaddle.to_tensor(preds), jpaddle.to_tensor(labels))
        np.testing.assert_allclose(port.accumulate(), ref.accumulate(),
                                   atol=1e-7, rtol=0)
    assert 0.0 < port.accumulate() < 1.0
    port.reset()
    assert port.accumulate() == 0.0


def test_auc_two_column_predictions_and_few_thresholds():
    port = paddle.metric.Auc(num_thresholds=15)
    ref = jpaddle.metric.Auc(num_thresholds=15)
    for preds, labels in _batches(2):
        two = np.stack([1 - preds, preds], axis=1)
        port.update(paddle.to_tensor(two), labels)
        ref.update(jpaddle.to_tensor(two), jpaddle.to_tensor(labels))
    np.testing.assert_allclose(port.accumulate(), ref.accumulate(),
                               atol=1e-7, rtol=0)
    np.testing.assert_array_equal(port._stat_pos, ref._stat_pos)
    np.testing.assert_array_equal(port._stat_neg, ref._stat_neg)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_accuracy_matches_the_reference(k):
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((64, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (64, 1)).astype(np.int64)
    want = float(np.asarray(jpaddle.metric.accuracy(
        jpaddle.to_tensor(logits), jpaddle.to_tensor(labels), k=k)._value))
    got = paddle.metric.accuracy(torch.from_numpy(logits),
                                 torch.from_numpy(labels), k=k)
    assert torch.is_tensor(got) and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, atol=1e-7, rtol=0)
    surface = paddle.metric.accuracy(paddle.to_tensor(logits),
                                     paddle.to_tensor(labels), k=k)
    assert isinstance(surface, paddle.Tensor)
    assert float(surface) == float(got)


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def _nets(name):
    if name == "lenet":
        from paddle_tpu.vision.models import LeNet
        jm, pm = LeNet(), models.LeNet(device="cpu")
        shape = [1, 1, 28, 28]
    else:
        from paddle_tpu.vision.models import resnet18
        jm, pm = resnet18(num_classes=10), \
            models.resnet18(num_classes=10, device="cpu")
        shape = [1, 3, 64, 64]
    load_jax_state(pm, jax_state(jm))
    return jm, pm, shape


@pytest.mark.parametrize("name", ["lenet", "resnet18"])
def test_summary_and_flops_equal_the_reference(name):
    jm, pm, shape = _nets(name)
    want, want_text = _printed(jpaddle.summary, jm, tuple(shape))
    got, got_text = _printed(paddle.summary, pm, tuple(shape))
    assert got == want and got_text == want_text
    assert _printed(paddle.Model(pm).summary, tuple(shape))[0] == want
    want_f, want_detail = _printed(jpaddle.flops, jm, shape,
                                   print_detail=True)
    got_f, got_detail = _printed(paddle.flops, pm, shape, print_detail=True)
    assert got_f == want_f > 0 and got_detail == want_detail
    assert pm.training   # flops puts the network back in its mode


def test_flops_custom_ops_and_frozen_parameters():
    net = models.LeNet(device="cpu")
    relus = paddle.flops(net, [2, 1, 28, 28], custom_ops={
        paddle.nn.ReLU: lambda layer, i, o: o.numel()})
    assert relus - paddle.flops(net, [2, 1, 28, 28]) == \
        2 * (6 * 28 * 28 + 16 * 10 * 10)
    for p in net.fc.parameters():
        p.requires_grad_(False)
    totals, _ = _printed(paddle.summary, net)
    assert totals["total_params"] == 61610
    assert totals["trainable_params"] == 61610 - (48120 + 10164 + 850)


def test_dlpack_round_trips():
    t = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    back = dlpack.from_dlpack(dlpack.to_dlpack(t))
    assert isinstance(back, paddle.Tensor)
    assert back._value.data_ptr() == t._value.data_ptr()   # no copy
    arr = np.arange(4, dtype=np.int64)
    from_np = dlpack.from_dlpack(arr)
    assert from_np._value.data_ptr() == arr.ctypes.data
    raw = dlpack.from_dlpack(arr.__dlpack__())   # a raw capsule: host
    assert raw.place == paddle.CPUPlace() and raw.tolist() == [0, 1, 2, 3]
    with pytest.raises(TypeError, match="paddle Tensor"):
        dlpack.to_dlpack(np.zeros(2))
    # across the packages, both ways, through capsules
    j = jpaddle.to_tensor(np.linspace(0, 1, 5, dtype=np.float32))
    from_ref = dlpack.from_dlpack(jdlpack.to_dlpack(j))
    np.testing.assert_array_equal(from_ref.numpy(), np.asarray(j._value))
    to_ref = jdlpack.from_dlpack(dlpack.to_dlpack(t))
    np.testing.assert_array_equal(np.asarray(to_ref._value), t.numpy())
