"""The port's ERNIE (``paddle_tpu_torch/text/ernie.py``) against the JAX
package on the same tiny model (hidden 128, 2 heads of 64, 2 layers,
vocab 256, ERNIE 3.0's task-type embedding), the port loaded with the
JAX model's weights, batches of 2 x 128 tokens with about half the
labels -100. Unmasked, the port's attention takes the kernel route, non
causal (the plain K2/K3 on the CPU); the JAX package runs as its own
tests run it, ``PDTPU_PALLAS_INTERPRET`` off, so its attention is dense.

Tolerances, those of ``tests/test_torch_train_step.py``: fp32 logits at
atol 1e-5, the loss at atol 1e-5 and every parameter gradient at atol
2e-6 (two frameworks summing in different orders through two layers;
gradients here are below 0.1); the 3-step AdamW trajectory at O0 at rtol
1e-5, the JAX package's own bound for its compiled step. At O2 both
compute in bf16 with rounding at different places (the port's losses
take fp32 logits, the JAX loss works in bf16), so the trajectory agrees
at rtol 2e-2, a few bf16 ulps of a loss near 5.6; that bound alone would
not catch a step that left some products in fp32, so the O2 test also
checks the dtype of every matrix product, of the tied decoder's logits
and of K3's inputs.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _torch_helpers import (TINY_ENCODER, jax_state, tiny_text_models,
                            token_batch)
from paddle_tpu.jit.train_step import CompiledTrainStep as JaxTrainStep
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn.functional import attention as port_attention
from paddle_tpu_torch.nn.layer.common import Linear
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.text import ernie

LR = 1e-3


@pytest.fixture(autouse=True)
def dense_jax_attention(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "0")


def _np(t):
    return np.asarray(t._value)


def _padded(seed):
    """ids and a [2, 128] keep mask: 77 and 128 real tokens."""
    ids, labels = token_batch(seed)
    mask = (np.arange(128)[None] < np.array([[77], [128]])).astype(np.int64)
    return ids, labels, mask


def _count(monkeypatch, name):
    calls = []
    real = getattr(ck, name)
    monkeypatch.setattr(ck, name, lambda *a, **kw: calls.append(
        a[0].dtype) or real(*a, **kw))
    return calls


def test_state_names_are_the_references():
    jm, pm = tiny_text_models("ernie", "ErnieForPretraining")
    names = [n for n, _ in pm.named_parameters()]
    assert sorted(names) == sorted(jax_state(jm))
    # the tied decoder weight is the word embedding's, registered once
    assert "cls._embedding.weight" not in dict(pm.state_dict())
    assert sum(p is pm.ernie.embeddings.word_embeddings.weight
               for p in pm.parameters()) == 1


def test_pretraining_logits_and_mlm_loss_match_jax(monkeypatch):
    jm, pm = tiny_text_models("ernie", "ErnieForPretraining")
    ids, labels = token_batch(0)
    fwd = _count(monkeypatch, "flash_attention_values")
    jpred, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    pred, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert len(fwd) == 2   # the kernel route, once per layer
    assert pred.shape == (2, 128, TINY_ENCODER["vocab_size"])
    np.testing.assert_allclose(pred.detach().numpy(), _np(jpred), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(loss.item(), float(_np(jloss)), atol=1e-5,
                               rtol=0)
    # token types and task types reach the embeddings in both packages
    rng = np.random.default_rng(1)
    tt, task = rng.integers(0, 4, (2, 128)), rng.integers(0, 3, (2, 128))
    jseq, jpool = jm.ernie(paddle.to_tensor(ids), paddle.to_tensor(tt),
                           task_type_ids=paddle.to_tensor(task))
    seq, pool = pm.ernie(torch.from_numpy(ids), torch.from_numpy(tt),
                         task_type_ids=torch.from_numpy(task))
    np.testing.assert_allclose(seq.detach().numpy(), _np(jseq), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pool.detach().numpy(), _np(jpool),
                               atol=1e-5, rtol=0)


def test_padded_batch_matches_jax_on_the_dense_path(monkeypatch):
    jm, pm = tiny_text_models("ernie", "ErnieForPretraining")
    ids, labels, mask = _padded(2)
    fwd = _count(monkeypatch, "flash_attention_values")
    jpred, jloss = jm(paddle.to_tensor(ids),
                      attention_mask=paddle.to_tensor(mask),
                      labels=paddle.to_tensor(labels))
    pred, loss = pm(torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask),
                    labels=torch.from_numpy(labels))
    assert fwd == []   # a mask sends attention down the dense path
    np.testing.assert_allclose(pred.detach().numpy(), _np(jpred), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(loss.item(), float(_np(jloss)), atol=1e-5,
                               rtol=0)
    # the mask matters: without it the padded sequence's outputs move
    unmasked = pm(torch.from_numpy(ids))
    assert float((unmasked[0] - pred[0]).abs().max().detach()) > 1e-3


@pytest.mark.parametrize("head", ["ErnieForSequenceClassification",
                                  "ErnieForTokenClassification",
                                  "ErnieForQuestionAnswering"])
def test_finetune_heads_match_jax(head):
    kw = {} if head == "ErnieForQuestionAnswering" else {"num_classes": 3}
    jm, pm = tiny_text_models("ernie", head, **kw)
    ids, _ = token_batch(3)
    rng = np.random.default_rng(4)
    targs, pargs = (paddle.to_tensor(ids),), (torch.from_numpy(ids),)
    if head == "ErnieForQuestionAnswering":
        jout, pout = jm(*targs), pm(*pargs)
    else:
        lab = rng.integers(0, 3, (2,) if "Sequence" in head else (2, 128))
        jout = jm(*targs, labels=paddle.to_tensor(lab))
        pout = pm(*pargs, labels=torch.from_numpy(lab))
    assert len(jout) == len(pout) == 2
    for j, p in zip(jout, pout):
        np.testing.assert_allclose(p.detach().numpy(), _np(j), atol=1e-5,
                                   rtol=0)


def _jax_grads(jm, ids, labels):
    _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    return float(_np(jloss)), {
        n: np.zeros(p.shape, np.float32) if p.grad is None else _np(p.grad)
        for n, p in jm.named_parameters()}


def test_every_gradient_matches_jax_including_the_tied_embedding():
    jm, pm = tiny_text_models("ernie", "ErnieForPretraining")
    pm.train()
    ids, labels = token_batch(5)
    jloss, jgrads = _jax_grads(jm, ids, labels)
    _, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, atol=1e-5, rtol=0)
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        if name.startswith("ernie.pooler"):
            # the MLM loss never reads the pooler
            assert g is None and not jgrads[name].any(), name
            continue
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=2e-6,
                                   rtol=0, err_msg=name)


def _port_step(pm, amp_level="O0", fn=None):
    opt = port_opt.AdamW(learning_rate=LR, parameters=pm.parameters())
    fn = fn or (lambda ids, labels: pm(ids, labels=labels)[1])
    return CompiledTrainStep(fn, pm, opt, amp_level=amp_level)


def _jax_step(jm, amp_level="O0", fn=None):
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=jm.parameters())
    fn = fn or (lambda ids, labels: jm(ids, labels=labels)[1])
    return JaxTrainStep(fn, jm, opt, amp_level=amp_level, donate=False)


def test_o0_step_gradients_match_jax_and_the_pooler_gets_zeros(
        monkeypatch):
    jm, pm = tiny_text_models("ernie", "ErnieForPretraining")
    pm.train()
    ids, labels = token_batch(6)
    jloss, jgrads = _jax_grads(jm, ids, labels)
    step = _port_step(pm)
    names = {id(p): n for n, p in pm.named_parameters()}
    seen = {}
    real = step.optimizer._apply

    def spy(p, g, lr):
        seen[names[id(p)]] = g.clone()
        return real(p, g, lr)

    monkeypatch.setattr(step.optimizer, "_apply", spy)
    bwd = _count(monkeypatch, "flash_attention_bwd")
    pooler = pm.ernie.pooler.dense.weight.detach().clone()
    loss = step(torch.from_numpy(ids), torch.from_numpy(labels))
    assert bwd == [torch.float32] * 2   # K3's route, once per layer
    np.testing.assert_allclose(float(loss), jloss, atol=1e-5, rtol=0)
    assert sorted(seen) == sorted(jgrads)
    for name, g in seen.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=2e-6,
                                   rtol=0, err_msg=name)
    assert not seen["ernie.pooler.dense.weight"].any()
    # a zero gradient leaves Adam's update at 0; the decoupled decay
    # (coefficient 0.01) still moves the pooler, as in the JAX step
    torch.testing.assert_close(pm.ernie.pooler.dense.weight.detach(),
                               pooler * (1 - LR * 0.01), atol=1e-7, rtol=0)


def test_o0_adamw_trajectory_matches_jax():
    jm, pm = tiny_text_models("ernie", "ErnieForPretraining")
    jstep, step = _jax_step(jm), _port_step(pm)
    want, got = [], []
    for i in range(3):
        ids, labels = token_batch(10 + i)
        want.append(float(_np(jstep(paddle.to_tensor(ids),
                                    paddle.to_tensor(labels)))))
        got.append(float(step(torch.from_numpy(ids),
                               torch.from_numpy(labels))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] < got[0]
    # Adam moves an entry by about lr per step whatever its gradient's
    # size, so parameters agree within 3 steps of lr
    jparams = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   _np(jparams[name]), atol=3 * LR, rtol=0,
                                   err_msg=name)


def _dtype_spies(pm):
    """Record (input, weight, output) dtypes of every matrix product and
    the tied decoder's output dtype."""
    seen = []
    for mod in pm.modules():
        if isinstance(mod, Linear):
            mod.register_forward_hook(lambda m, inp, out: seen.append(
                (inp[0].dtype, m.weight.dtype, out.dtype)))
    pm.cls.register_forward_hook(lambda m, inp, out: seen.append(
        (out.dtype,)))
    return seen


def test_o2_trajectory_matches_jax_and_keeps_fp32_params(monkeypatch):
    jm, pm = tiny_text_models("ernie", "ErnieForPretraining")
    jstep, step = _jax_step(jm, "O2"), _port_step(pm, "O2")
    bwd = _count(monkeypatch, "flash_attention_bwd")
    seen = _dtype_spies(pm)
    want, got = [], []
    for i in range(3):
        ids, labels = token_batch(20 + i)
        want.append(float(_np(jstep(paddle.to_tensor(ids),
                                    paddle.to_tensor(labels)))))
        got.append(float(step(torch.from_numpy(ids),
                              torch.from_numpy(labels))))
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert bwd == [torch.bfloat16] * 6   # 2 layers x 3 steps, in bf16
    # 3 steps x (2 layers x 6 Linears + pooler + transform + decoder)
    assert len(seen) == 3 * (2 * 6 + 3)
    assert all(dt == torch.bfloat16 for rec in seen for dt in rec)
    for p in pm.parameters():
        assert p.dtype == torch.float32
    accs = step.optimizer._get_accumulators(
        pm.ernie.embeddings.word_embeddings.weight)
    assert accs["moment1"].dtype == torch.float32


def test_o2_padded_batch_promotes_the_masked_scores_to_fp32(monkeypatch):
    """bf16 scores plus the fp32 -1e4 mask are fp32 in both packages."""
    jm, pm = tiny_text_models("ernie", "ErnieForPretraining")
    fn = (lambda m: lambda ids, mask, labels: m(
        ids, attention_mask=mask, labels=labels)[1])
    jstep, step = _jax_step(jm, "O2", fn(jm)), _port_step(pm, "O2", fn(pm))
    dense = []
    real = port_attention._sdpa_impl

    def spy(q, k, v, mask, scale, is_causal):
        out = real(q, k, v, mask, scale, is_causal)
        dense.append((q.dtype, mask.dtype,
                      torch.result_type(q, mask), out.dtype))
        return out

    monkeypatch.setattr(port_attention, "_sdpa_impl", spy)
    ids, labels, mask = _padded(30)
    want = float(_np(jstep(*map(paddle.to_tensor, (ids, mask, labels)))))
    got = float(step(*map(torch.from_numpy, (ids, mask, labels))))
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert dense == [(torch.bfloat16, torch.float32, torch.float32,
                      torch.bfloat16)] * 2


def test_run_steps_equals_sequential_calls():
    ids_k, labels_k = token_batch(40, k=2)
    _, pm1 = tiny_text_models("ernie", "ErnieForPretraining")
    step1 = _port_step(pm1)
    seq = [step1(torch.from_numpy(i), torch.from_numpy(lb))
           for i, lb in zip(ids_k, labels_k)]
    _, pm2 = tiny_text_models("ernie", "ErnieForPretraining")
    losses = _port_step(pm2).run_steps(torch.from_numpy(ids_k),
                                       torch.from_numpy(labels_k))
    assert torch.equal(losses, torch.stack(seq))
    for p1, p2 in zip(pm1.parameters(), pm2.parameters()):
        assert torch.equal(p1, p2)


def test_encoder_layers_start_as_deep_copies():
    """The reference's ``TransformerEncoder`` deep-copies its layer, so
    both packages' layers start equal (ROADMAP C, divergences by
    design)."""
    jm, _ = tiny_text_models("ernie", "ErnieForPretraining")
    pm = ernie.ErnieForPretraining(ernie.ErnieConfig(**TINY_ENCODER),
                                   device="cpu", seed=7)
    jl = [dict(layer.named_parameters()) for layer in jm.ernie.encoder.layers]
    pl = [dict(layer.named_parameters()) for layer in pm.ernie.encoder.layers]
    for name in pl[0]:
        np.testing.assert_array_equal(_np(jl[1][name]), _np(jl[0][name]))
        assert torch.equal(pl[1][name], pl[0][name])
        assert pl[1][name] is not pl[0][name]


def test_seeded_weights_are_the_same_on_every_build():
    cfg = ernie.ErnieConfig(**TINY_ENCODER)
    a = ernie.ErnieForPretraining(cfg, device="cpu", seed=3)
    b = ernie.ErnieForPretraining(cfg, device="cpu", seed=3)
    c = ernie.ErnieForPretraining(cfg, device="cpu", seed=4)
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q), n
    emb = a.ernie.embeddings.word_embeddings.weight
    assert not torch.equal(emb, c.ernie.embeddings.word_embeddings.weight)
    # embeddings normal(0, initializer_range)
    assert abs(float(emb.detach().std()) - 0.02) < 0.002


def test_load_jax_state_refuses_a_mismatch():
    jm, pm = tiny_text_models("ernie", "ErnieForPretraining")
    state = jax_state(jm)
    missing = dict(state)
    del missing["cls.decoder_bias"]
    with pytest.raises(KeyError, match="missing.*cls.decoder_bias"):
        load_jax_state(pm, missing)
    with pytest.raises(KeyError, match="unexpected.*cls.decoder.weight"):
        load_jax_state(pm, {**state, "cls.decoder.weight": np.zeros(3)})
    bad = dict(state)
    bad["ernie.pooler.dense.bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="ernie.pooler.dense.bias"):
        load_jax_state(pm, bad)


def test_presets_and_the_device_rule_match_jax():
    from paddle_tpu.text import ernie as jernie
    for preset in ("ernie_3_0_base", "ernie_3_0_medium", "ernie_3_0_mini"):
        assert vars(getattr(ernie, preset)()) == \
            vars(getattr(jernie, preset)())
    assert vars(ernie.ErnieConfig()) == vars(jernie.ErnieConfig())
    cfg = ernie.ErnieConfig(**TINY_ENCODER)
    if torch.cuda.is_available():
        assert ernie.ErnieForPretraining(cfg).cls.decoder_bias.is_cuda
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ernie.ErnieForPretraining(cfg)
