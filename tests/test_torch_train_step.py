"""The port's training step (``paddle_tpu_torch/jit/train_step.py``) on the
tiny GPT both packages build (hidden 128, 2 heads of 64, 2 layers, vocab
128), the port loaded with the JAX model's weights, batches of 2 x 128
tokens so the port's attention takes the kernel route (K2 forward, K3
backward; their plain versions on the CPU).

The JAX side runs as its own tests run it on the CPU: the attention
takes the dense path (``PDTPU_PALLAS_INTERPRET`` off, so the gate refuses
the Pallas kernel below 512 tokens).

Tolerances, fp32: the loss at atol 1e-5 and every parameter gradient at
atol 2e-6 (two frameworks summing in different orders through two
layers; gradients here are below 0.1); the 3-step AdamW loss trajectory
at O0 at rtol 1e-5, the JAX package's own bound for its compiled step
(``tests/test_train_step_and_flash.py``). At O2 both compute in bf16
with rounding at different places (the port's loss upcasts the logits to
fp32, the JAX loss works in bf16), so the trajectory agrees at rtol 2e-2,
a few bf16 ulps of a loss near 4.8; that bound alone would not catch a
step that left some products in fp32, so the O2 test also checks the
dtype of every matrix product and of the logits.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _torch_helpers import tiny_models
from paddle_tpu.jit.train_step import CompiledTrainStep as JaxTrainStep
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn.clip import ClipGradByValue
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.text import gpt


@pytest.fixture(autouse=True)
def dense_jax_attention(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "0")


def _batch(seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (2, 128) if k is None else (k, 2, 128)
    return rng.integers(0, 128, shape), rng.integers(0, 128, shape)


def _port_step(pm, amp_level="O0", **opt_kw):
    opt = port_opt.AdamW(parameters=pm.parameters(),
                         **{"learning_rate": 1e-3, **opt_kw})
    return CompiledTrainStep(
        lambda ids, labels: pm(ids, labels=labels)[1], pm, opt,
        amp_level=amp_level)


def _jax_step(jm, amp_level="O0"):
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=jm.parameters())
    return JaxTrainStep(lambda ids, labels: jm(ids, labels=labels)[1], jm,
                        opt, amp_level=amp_level, donate=False)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_loss_and_every_gradient_match_jax(tied, monkeypatch):
    jm, pm = tiny_models(tied=tied)
    jm.train()
    pm.train()
    ids, labels = _batch(0)
    _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    calls = []
    real = ck.flash_attention_bwd
    monkeypatch.setattr(ck, "flash_attention_bwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    assert len(calls) == 2   # one K3 backward per layer
    np.testing.assert_allclose(loss.item(), float(np.asarray(jloss._value)),
                               atol=1e-5, rtol=0)
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=2e-6,
                                   rtol=0, err_msg=name)


def test_o0_adamw_trajectory_matches_jax():
    jm, pm = tiny_models()
    jstep, step = _jax_step(jm), _port_step(pm)
    want, got = [], []
    for i in range(3):
        ids, labels = _batch(10 + i)
        want.append(float(np.asarray(jstep(paddle.to_tensor(ids),
                                           paddle.to_tensor(labels))._value)))
        loss = step(torch.from_numpy(ids), torch.from_numpy(labels))
        assert loss.dtype == torch.float32 and loss.ndim == 0
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] < got[0]
    assert step.optimizer._step_count == 3
    # Adam moves an entry by about lr per step whatever its gradient's
    # size, so an entry whose gradient is near zero may move differently
    # in the two packages: parameters agree within 3 steps of lr
    jparams = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[name]._value),
                                   atol=3e-3, rtol=0, err_msg=name)


def test_o2_trajectory_matches_jax_and_keeps_fp32_params(monkeypatch):
    jm, pm = tiny_models()
    jstep, step = _jax_step(jm, "O2"), _port_step(pm, "O2")
    dtypes = []
    real = ck.flash_attention_bwd
    monkeypatch.setattr(ck, "flash_attention_bwd",
                        lambda *a, **kw: dtypes.append(a[0].dtype)
                        or real(*a, **kw))
    # the rtol below cannot tell a half-cast step from a bf16 one, so the
    # dtypes are checked where they are computed: every matrix product's
    # input, weight and output, and the logits
    seen = []
    for mod in pm.modules():
        if isinstance(mod, gpt.Linear):
            mod.register_forward_hook(lambda m, inp, out: seen.append(
                (inp[0].dtype, m.weight.dtype, out.dtype)))
    pm.register_forward_hook(lambda m, inp, out: seen.append(
        (out[0].dtype,)))
    want, got = [], []
    for i in range(3):
        ids, labels = _batch(20 + i)
        want.append(float(np.asarray(jstep(paddle.to_tensor(ids),
                                           paddle.to_tensor(labels))._value)))
        got.append(float(step(torch.from_numpy(ids),
                              torch.from_numpy(labels))))
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert dtypes == [torch.bfloat16] * 6   # 2 layers x 3 steps, in bf16
    # 3 steps x (2 layers x 4 Linears + the logits)
    assert len(seen) == 27
    assert all(dt == torch.bfloat16 for rec in seen for dt in rec)
    for p in pm.parameters():
        assert p.dtype == torch.float32
    accs = step.optimizer._get_accumulators(pm.gpt.wte.weight)
    assert accs["moment1"].dtype == torch.float32
    assert "master_weight" not in accs   # fp32 params need no master


def test_run_steps_equals_sequential_calls():
    ids_k, labels_k = _batch(30, k=3)
    _, pm1 = tiny_models()
    step1 = _port_step(pm1)
    seq = [step1(torch.from_numpy(i), torch.from_numpy(lb))
           for i, lb in zip(ids_k, labels_k)]
    _, pm2 = tiny_models()
    step2 = _port_step(pm2)
    losses = step2.run_steps(torch.from_numpy(ids_k),
                             torch.from_numpy(labels_k))
    assert losses.shape == (3,)
    assert torch.equal(losses, torch.stack(seq))
    for p1, p2 in zip(pm1.parameters(), pm2.parameters()):
        assert torch.equal(p1, p2)
    assert step2.optimizer._step_count == 3


def test_run_steps_creates_masters_before_the_loop():
    _, pm = tiny_models()
    pm.to(torch.bfloat16)
    step = _port_step(pm, multi_precision=True)
    seen = []
    real = step._step

    def spy(*a):
        seen.append(all("master_weight" in step.optimizer._get_accumulators(p)
                        for p in step.trainable))
        return real(*a)

    step._step = spy
    ids_k, labels_k = _batch(40, k=2)
    losses = step.run_steps(torch.from_numpy(ids_k),
                            torch.from_numpy(labels_k))
    assert seen == [True, True] and bool(torch.isfinite(losses).all())
    for p in step.trainable:
        master = step.optimizer._get_accumulators(p)["master_weight"]
        assert torch.equal(p.detach(), master.to(torch.bfloat16))


def test_clip_and_refusals():
    _, pm = tiny_models()
    opt = port_opt.SGD(learning_rate=1.0, parameters=pm.parameters(),
                       grad_clip=ClipGradByValue(1e-6))
    before = [p.detach().clone() for p in pm.parameters()]
    step = CompiledTrainStep(lambda i, lb: pm(i, labels=lb)[1], pm, opt)
    step(*map(torch.from_numpy, _batch(50)))
    for b, p in zip(before, pm.parameters()):
        # lr 1, every gradient clipped to 1e-6: no entry moves more (the
        # JAX package's bound, which leaves room for fp32 rounding)
        assert float((p.detach() - b).abs().max()) <= 1e-5
    # the StepMeter hook returns the step; O1 casts nothing of its own
    # (ops follow the ambient auto_cast state), as in the reference
    assert step.set_meter_info(tokens_per_step=256) is step
    assert step.meter_tokens == 256
    o1 = CompiledTrainStep(lambda i, lb: pm(i, labels=lb)[1], pm, opt,
                           amp_level="O1")
    loss = o1(*map(torch.from_numpy, _batch(51)))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


def test_flops_per_token_matches_jax():
    for tied in (True, False):
        jm, pm = tiny_models(tied=tied)
        assert pm.num_parameters() == jm.num_parameters()
        assert pm.flops_per_token() == jm.flops_per_token()
