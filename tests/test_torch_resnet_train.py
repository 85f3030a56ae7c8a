"""ResNet-18's ``CompiledTrainStep`` with Momentum (lr 0.01, momentum
0.9) in the port against the JAX package's, the port loaded with the JAX
model's weights, over 3 steps of 4 x 3 x 64 x 64 images, 10 classes.

- A 3-step trajectory with the batch norms on their running statistics:
  at O0 the losses within rtol 1e-4 and the parameters after them within
  1e-4 of each tensor's largest entry; at O2 the losses within rtol 2e-2
  (bf16 compute in both packages, rounded at different places; the bound
  of ``test_torch_train_step.py``).
- 3 training-mode steps (batch statistics, running statistics updated),
  each from the JAX model's state (parameters, running statistics,
  velocities loaded into the port first): the losses within rtol 1e-5
  (O0) and 2e-2 (O2), the running statistics each step leaves within
  1e-4 (O0) and 5e-2 (O2) of their largest entries (under O2 they are
  fp32 sums of bf16 activations rounded at different places through 8
  blocks; 2.9e-2 measured, at the last stage's small channel means). A
  compounding training-mode trajectory is not compared: fp32 determines its
  gradients poorly at random initialization, and the JAX package's
  batch-norm backward is 4e-2 of the largest entry off fp64 on this
  draw, so the two trajectories part by 1e-2 at step 2
  (``test_torch_resnet.py``'s docstring has the measurements).
- Every convolution, batch norm and the classifier compute in bf16
  under O2; parameters and running statistics stay fp32 and outside
  autograd; ``run_steps`` over 3 batches equals 3 calls bit for bit, and
  each batch norm's statistics move once a step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train_step import CompiledTrainStep as JaxTrainStep
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import CompiledTrainStep
from _torch_helpers import jax_state
from paddle_tpu_torch.convert import load_jax_state
from test_torch_resnet import _images, _np, _pair, _stats

LR, MOMENTUM = 0.01, 0.9


def _steps(amp_level, train_mode, sync=False, k=3):
    """Per-call losses of a 3-step Momentum trajectory on ResNet-18 in
    both packages, and the two models after it. ``train_mode=False``
    puts both networks in eval mode first (batch norms on their running
    statistics); ``sync`` loads the JAX model's parameters, running
    statistics and velocities into the port before each step."""
    jm, pm = _pair(18, seed=2)
    if not train_mode:
        jm.eval()
        pm.eval()
    jopt = paddle.optimizer.Momentum(learning_rate=LR, momentum=MOMENTUM,
                                     parameters=jm.parameters())
    popt = port_opt.Momentum(learning_rate=LR, momentum=MOMENTUM,
                             parameters=pm.parameters())
    jloss, ploss = paddle.nn.CrossEntropyLoss(), pnn.CrossEntropyLoss()
    jstep = JaxTrainStep(lambda x, y: jloss(jm(x), y), jm, jopt,
                         amp_level=amp_level)
    pstep = CompiledTrainStep(lambda x, y: ploss(pm(x), y), pm, popt,
                              amp_level=amp_level)
    xs, ys = _images(7, 4, k=k)
    want, got, stats = [], [], []
    for x, y in zip(xs, ys):
        if sync:
            load_jax_state(pm, jax_state(jm))
            jparams = dict(jm.named_parameters())
            for name, p in pm.named_parameters():
                v = jopt._get_accumulators(jparams[name])["velocity"]
                popt._get_accumulators(p)["velocity"].copy_(
                    torch.from_numpy(np.array(v)))
        want.append(float(_np(jstep(paddle.to_tensor(x),
                                    paddle.to_tensor(y)))))
        got.append(float(pstep(torch.from_numpy(x), torch.from_numpy(y))))
        stats.append((_stats(jm), _stats(pm)))
    return want, got, jm, pm, stats


def _close_to_jax(pm, jm, named, bound):
    """Every tensor of ``named(pm)`` within ``bound`` of its JAX
    counterpart's largest entry."""
    want = dict(named(jm))
    for name, t in named(pm):
        w = _np(want[name])
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=0,
                                   atol=bound * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("amp_level,rtol", [("O0", 1e-4), ("O2", 2e-2)])
def test_momentum_trajectory_matches_jax(amp_level, rtol):
    # batch norms on their running statistics: the backward is well
    # conditioned, so 3 compounding steps stay comparable (module doc)
    want, got, jm, pm, _ = _steps(amp_level, train_mode=False)
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[2] < got[0]
    if amp_level == "O0":
        _close_to_jax(pm, jm, lambda m: m.named_parameters(), 1e-4)
    for p in pm.parameters():
        assert p.dtype == torch.float32


@pytest.mark.parametrize("amp_level,rtol", [("O0", 1e-5), ("O2", 2e-2)])
def test_training_mode_steps_match_jax_from_shared_state(amp_level, rtol):
    # batch statistics in the forward; each step starts from the JAX
    # model's state, so fp32's poorly determined training-mode gradients
    # (module doc) do not compound: the losses and the running statistics
    # each step leaves agree
    want, got, jm, pm, stats = _steps(amp_level, train_mode=True,
                                      sync=True)
    np.testing.assert_allclose(got, want, rtol=rtol)
    for jstats, pstats in stats:
        for name, v in pstats.items():
            assert v.dtype == np.float32
            top = float(np.abs(jstats[name]).max())
            np.testing.assert_allclose(v, jstats[name], rtol=0,
                                       atol=(1e-4 if amp_level == "O0"
                                             else 5e-2) * top,
                                       err_msg=name)
    for b in pm.buffers():
        assert b.dtype == torch.float32 and b.grad_fn is None
        assert not b.requires_grad


def test_o2_computes_in_bf16():
    _, pm = _pair(18, seed=3)
    opt = port_opt.Momentum(learning_rate=LR, parameters=pm.parameters())
    loss_fn = pnn.CrossEntropyLoss()
    seen = []
    for mod in pm.modules():
        if isinstance(mod, (pnn.Conv2D, pnn.BatchNorm2D, pnn.Linear)):
            mod.register_forward_hook(lambda m, inp, out: seen.append(
                (type(m).__name__, out.dtype)))
    step = CompiledTrainStep(lambda x, y: loss_fn(pm(x), y), pm, opt,
                             amp_level="O2")
    x, y = _images(8, 4)
    step(torch.from_numpy(x), torch.from_numpy(y))
    # 20 convolutions, 20 batch norms and the classifier, all bf16
    assert len(seen) == 41
    assert {dt for _, dt in seen} == {torch.bfloat16}


def test_run_steps_equals_calls_and_updates_statistics_once_a_step():
    xs, ys = _images(9, 4, k=3)
    _, pm1 = _pair(18, seed=4)
    _, pm2 = _pair(18, seed=4)
    updates = []
    bn = pm2.layer4[1].bn2
    bn.register_forward_hook(lambda m, inp, out: updates.append(
        m._mean.clone()))
    results = []
    for pm, run in ((pm1, False), (pm2, True)):
        opt = port_opt.Momentum(learning_rate=LR, parameters=pm.parameters())
        loss_fn = pnn.CrossEntropyLoss()
        step = CompiledTrainStep(lambda x, y: loss_fn(pm(x), y), pm, opt,
                                 amp_level="O2")
        if run:
            results.append(step.run_steps(torch.from_numpy(xs),
                                          torch.from_numpy(ys)))
        else:
            results.append(torch.stack([
                step(torch.from_numpy(x), torch.from_numpy(y))
                for x, y in zip(xs, ys)]))
        assert step.optimizer._step_count == 3
    assert torch.equal(results[0], results[1])
    for (n1, t1), (_, t2) in zip(pm1.state_dict().items(),
                                 pm2.state_dict().items()):
        assert torch.equal(t1, t2), n1
    # one update a step, each different from the one before it, in fp32
    assert len(updates) == 3
    assert all(u.dtype == torch.float32 for u in updates)
    assert not any(torch.equal(a, b) for a, b in zip(updates, updates[1:]))
    assert bn._mean.grad_fn is None and not bn._mean.requires_grad
