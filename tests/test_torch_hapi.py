"""The port's ``hapi.Model``, ``io`` and ``metric`` against the JAX
package's on seeded numpy data, the port's networks loaded with the JAX
networks' weights.

- ``fit``'s per-step losses, read by a callback: LeNet with Adam (lr
  1e-3, batch 8, 3 steps, O0) within rtol 1e-4 of the JAX ``Model.fit``'s
  and its parameters after them within 1e-5; ResNet-18 with Momentum at
  O2 (batch 4 of 3 x 64 x 64, 3 steps, ``steps_per_execution=3``): the
  first step's loss within rtol 2e-2 of JAX's (bf16 compute in both), and
  every step's equal, bit for bit, to the port's own ``CompiledTrainStep``
  on the same batches. Later ResNet steps are not held to JAX: fp32
  determines training-mode batch-norm gradients at random initialization
  poorly and the reference's batch-norm backward is further off
  (``tests/test_torch_resnet.py``'s docstring).
- ``steps_per_execution=4`` gives the same losses and weights as 1, with
  a ragged last batch run on its own.
- ``evaluate`` (loss and ``Accuracy`` top-1 and top-2) and ``predict`` on
  ResNet-18 in eval mode within 1e-5 of JAX's (continuous random logits,
  so no ties reorder the top-k).
- ``DataLoader``: order, ``shuffle`` under ``np.random.seed`` (the same
  permutation as JAX's), ``drop_last``, the collate; the refusals left
  (``Model.save(training=False)``, ``VisualDL``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _torch_helpers import jax_state
from paddle_tpu.hapi.callbacks import Callback as JaxCallback
from paddle_tpu_torch import metric as port_metric
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi.callbacks import (Callback, EarlyStopping,
                                             ModelCheckpoint, VisualDL)
from paddle_tpu_torch.io import (BatchSampler, DataLoader, RandomSampler,
                                 TensorDataset)
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.vision import models


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.losses, self.steps = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
            self.steps.append((step, logs["batch_size"]))
    return Recorder()


def _images(seed, n, shape, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n,) + shape).astype(np.float32),
            rng.integers(0, classes, (n,)).astype(np.int64))


def _jax_loader(arrays, batch_size):
    """A JAX ``DataLoader`` in order. Handed a dataset, the JAX ``Model``
    shards it over the test session's 8 virtual CPU devices as data-parallel
    ranks; a loader it takes as it is."""
    return paddle.io.DataLoader(paddle.io.TensorDataset(list(arrays)),
                                batch_size=batch_size, shuffle=False)


def _fit_both(jnet, pnet, jopt, popt, data, batch_size, amp=None,
              **fit_kw):
    rec = {}
    for name, model_cls, net, opt, loss, loader, base in (
            ("jax", paddle.Model, jnet, jopt, paddle.nn.CrossEntropyLoss(),
             _jax_loader(data, batch_size), JaxCallback),
            ("port", Model, pnet, popt, pnn.CrossEntropyLoss(),
             TensorDataset(list(data)), Callback)):
        rec[name] = _recorder(base)
        model_cls(net).prepare(opt, loss, amp_configs=amp).fit(
            loader, batch_size=batch_size, shuffle=False, verbose=0,
            callbacks=[rec[name]], **fit_kw)
    return rec["jax"], rec["port"]


def test_lenet_fit_matches_jax():
    paddle.seed(5)
    jnet = paddle.vision.models.LeNet()
    pnet = models.LeNet(device="cpu")
    load_jax_state(pnet, jax_state(jnet))
    jopt = paddle.optimizer.Adam(learning_rate=1e-3,
                                 parameters=jnet.parameters())
    popt = port_opt.Adam(learning_rate=1e-3, parameters=pnet.parameters())
    jrec, prec = _fit_both(jnet, pnet, jopt, popt,
                           _images(5, 24, (1, 28, 28)), batch_size=8)
    assert prec.steps == jrec.steps == [(0, 8), (1, 8), (2, 8)]
    np.testing.assert_allclose(prec.losses, jrec.losses, rtol=1e-4)
    jparams = dict(jnet.named_parameters())
    for name, p in pnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[name]._value),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_resnet18_fit_o2_blocks_match_jax_and_the_train_step():
    data = _images(6, 12, (3, 64, 64))
    paddle.seed(6)
    jnet = paddle.vision.models.resnet18(num_classes=10)
    pnet = models.resnet18(num_classes=10, device="cpu")
    state = jax_state(jnet)
    load_jax_state(pnet, state)
    jopt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                     parameters=jnet.parameters())
    popt = port_opt.Momentum(learning_rate=0.01, momentum=0.9,
                             parameters=pnet.parameters())
    jrec, prec = _fit_both(jnet, pnet, jopt, popt, data, amp="O2",
                           batch_size=4, steps_per_execution=3)
    assert prec.steps == jrec.steps == [(0, 4), (1, 4), (2, 4)]
    np.testing.assert_allclose(prec.losses[0], jrec.losses[0], rtol=2e-2)
    # the same three steps through the port's train step directly
    net = models.resnet18(num_classes=10, device="cpu")
    load_jax_state(net, state)
    opt = port_opt.Momentum(learning_rate=0.01, momentum=0.9,
                            parameters=net.parameters())
    loss_fn = pnn.CrossEntropyLoss()
    step = CompiledTrainStep(lambda x, y: loss_fn(net(x), y), net, opt,
                             amp_level="O2")
    x, y = (torch.from_numpy(a).reshape(3, 4, *a.shape[1:]) for a in data)
    assert step.run_steps(x, y).tolist() == prec.losses
    for (name, a), b in zip(pnet.state_dict().items(),
                            net.state_dict().values()):
        assert torch.equal(a, b), name


def test_steps_per_execution_equals_one_step_at_a_time():
    data = _images(7, 11, (3, 32, 32))
    results = []
    for spe in (1, 4):
        net = models.resnet18(num_classes=10, device="cpu", seed=7)
        opt = port_opt.Momentum(learning_rate=0.01,
                                parameters=net.parameters())
        rec = _recorder(Callback)
        Model(net).prepare(opt, pnn.CrossEntropyLoss()).fit(
            TensorDataset(list(data)), batch_size=3, shuffle=False,
            verbose=0, callbacks=[rec], steps_per_execution=spe)
        results.append((rec, net.state_dict()))
    (r1, s1), (r4, s4) = results
    # 11 samples in batches of 3: a block of 3 and the ragged last batch
    assert r1.steps == r4.steps == [(0, 3), (1, 3), (2, 3), (3, 2)]
    assert r1.losses == r4.losses
    for name, t in s1.items():
        assert torch.equal(t, s4[name]), name


def test_steps_per_execution_with_metrics_warns_and_steps_singly():
    net = models.LeNet(device="cpu", seed=8)
    opt = port_opt.Adam(parameters=net.parameters())
    model = Model(net).prepare(opt, pnn.CrossEntropyLoss(),
                               metrics=port_metric.Accuracy())
    rec = _recorder(Callback)
    with pytest.warns(UserWarning, match="one step per execution"):
        model.fit(TensorDataset(list(_images(8, 8, (1, 28, 28)))),
                  batch_size=4, verbose=0, callbacks=[rec],
                  steps_per_execution=2)
    assert len(rec.losses) == 2


@pytest.fixture(scope="module")
def eval_pair():
    paddle.seed(9)
    jnet = paddle.vision.models.resnet18(num_classes=10)
    pnet = models.resnet18(num_classes=10, device="cpu")
    load_jax_state(pnet, jax_state(jnet))
    return jnet, pnet


def test_evaluate_with_accuracy_matches_jax(eval_pair):
    jnet, pnet = eval_pair
    data = _images(9, 12, (3, 32, 32))
    jm = paddle.Model(jnet).prepare(
        None, paddle.nn.CrossEntropyLoss(),
        metrics=paddle.metric.Accuracy(topk=(1, 2)))
    pm = Model(pnet).prepare(None, pnn.CrossEntropyLoss(),
                             metrics=port_metric.Accuracy(topk=(1, 2)))
    want = jm.evaluate(_jax_loader(data, 4), verbose=0)
    got = pm.evaluate(TensorDataset(list(data)), batch_size=4, verbose=0)
    assert sorted(got) == sorted(want) == ["acc_top1", "acc_top2", "loss"]
    assert got["acc_top1"] == want["acc_top1"]
    assert got["acc_top2"] == want["acc_top2"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert not pnet.training


def test_predict_matches_jax(eval_pair):
    jnet, pnet = eval_pair
    x, _ = _images(10, 6, (3, 32, 32))
    want = paddle.Model(jnet).predict(_jax_loader([x], 4),
                                      stack_outputs=True)
    got = Model(pnet).predict(TensorDataset([x]), batch_size=4,
                              stack_outputs=True)
    assert got[0].shape == want[0].shape == (6, 10)
    np.testing.assert_allclose(got[0], want[0],
                               atol=1e-5 * np.abs(want[0]).max(), rtol=0)
    batches = Model(pnet).predict(TensorDataset([x]), batch_size=4)
    assert [b[0].shape for b in batches] == [(4, 10), (2, 10)]


def test_accuracy_metric_matches_jax():
    rng = np.random.default_rng(11)
    pred = rng.standard_normal((16, 5)).astype(np.float32)
    label = rng.integers(0, 5, (16, 1))
    jacc, pacc = paddle.metric.Accuracy(topk=(1, 3)), \
        port_metric.Accuracy(topk=(1, 3))
    for half in (slice(0, 8), slice(8, 16)):
        want = jacc.update(jacc.compute(paddle.to_tensor(pred[half]),
                                        paddle.to_tensor(label[half])))
        got = pacc.update(pacc.compute(torch.from_numpy(pred[half]),
                                       torch.from_numpy(label[half])))
        assert got == want
    assert pacc.accumulate() == jacc.accumulate()
    assert pacc.name() == jacc.name() == ["acc_top1", "acc_top3"]


def test_dataloader_order_shuffle_and_drop_last():
    x = np.arange(10, dtype=np.float32).reshape(10, 1)
    y = np.arange(10)
    ds = TensorDataset([x, y])
    batches = list(DataLoader(ds, batch_size=4))
    assert [b[1].tolist() for b in batches] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                               [8, 9]]
    assert batches[0][0].dtype == torch.float32 and \
        tuple(batches[0][0].shape) == (4, 1)
    assert [b[1].tolist() for b in DataLoader(ds, batch_size=4,
                                              drop_last=True)] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert len(DataLoader(ds, batch_size=4, drop_last=True)) == 2
    # shuffle draws from numpy's global generator, as the reference does
    np.random.seed(3)
    got = [b[1].tolist() for b in DataLoader(ds, batch_size=4,
                                             shuffle=True)]
    np.random.seed(3)
    want = [np.asarray(b[1]).tolist()
            for b in paddle.io.DataLoader(paddle.io.TensorDataset([x, y]),
                                          batch_size=4, shuffle=True)]
    assert got == want and sorted(sum(got, [])) == list(range(10))
    np.random.seed(3)
    assert list(BatchSampler(sampler=RandomSampler(ds), batch_size=4)) == \
        want


def test_collate_of_arrays_tensors_numbers_and_dicts():
    x = np.random.default_rng(12).standard_normal((6, 2, 3)) \
        .astype(np.float32)
    y = np.arange(6)
    arrays = list(DataLoader(TensorDataset([x, y]), batch_size=4))
    tensors = list(DataLoader(TensorDataset([torch.from_numpy(x),
                                             torch.from_numpy(y)]),
                              batch_size=4))
    numbers = list(DataLoader([(x[i], int(y[i])) for i in range(6)],
                              batch_size=4))
    for (ax, ay), (tx, ty), (nx, ny) in zip(arrays, tensors, numbers):
        assert torch.equal(ax, tx) and torch.equal(ax, nx)
        assert torch.equal(ay, ty) and torch.equal(ay, ny)
    assert torch.equal(arrays[1][0], torch.from_numpy(x[4:]))
    dicts = list(DataLoader([{"a": np.ones(2), "b": 1}] * 3, batch_size=2))
    assert tuple(dicts[0]["a"].shape) == (2, 2) and \
        dicts[1]["b"].tolist() == [1]


def test_eager_train_batch_and_early_stopping():
    net = models.LeNet(device="cpu", seed=13)
    opt = port_opt.SGD(learning_rate=0.0, parameters=net.parameters())
    model = Model(net).prepare(opt, pnn.CrossEntropyLoss())
    x, y = _images(13, 4, (1, 28, 28))
    # update=False: the eager backward, gradients left for the caller
    loss = model.train_batch([x], [y], update=False)
    assert isinstance(loss[0], float)
    assert all(p.grad is not None for p in net.parameters())
    stopper = EarlyStopping(monitor="loss", patience=0, verbose=0)
    model.fit(TensorDataset([x, y]), batch_size=4, epochs=5, verbose=0,
              callbacks=[stopper])
    # lr 0: the loss never improves, so training stops after epoch 2
    assert model.stop_training and stopper.wait == 1


def test_refusals():
    net = models.LeNet(device="cpu", seed=14)
    model = Model(net).prepare(port_opt.SGD(parameters=net.parameters()),
                               pnn.CrossEntropyLoss())
    # what is left after checkpoints and workers were ported: the
    # inference export and the VisualDL callback
    with pytest.raises(NotImplementedError, match="A10"):
        model.save("x", training=False)
    with pytest.raises(NotImplementedError, match="A9"):
        VisualDL()
    assert isinstance(ModelCheckpoint(), Callback)
    loader = DataLoader(TensorDataset([np.zeros((2, 1))]), num_workers=2,
                        use_shared_memory=False, timeout=60)
    assert [b[0].shape[0] for b in loader] == [1, 1]
