"""The port's BERT (``paddle_tpu_torch/text/bert.py``) against the JAX
package on the same tiny model (hidden 128, 2 heads of 64, 2 layers,
vocab 256), the port loaded with the JAX model's weights, batches of 2 x
128 tokens: ``BertForSequenceClassification`` (the finetuning model)
forward, every gradient and its training step, the other heads, and
``BertForPretraining``'s forward and gradients. Unmasked, the port's
attention takes the kernel route, non causal (the plain K2/K3 on the
CPU); the JAX package runs as its own tests run it,
``PDTPU_PALLAS_INTERPRET`` off, so its attention is dense.

Tolerances, those of ``tests/test_torch_train_step.py`` where they
carry over: fp32 outputs and losses at atol 1e-5; every parameter
gradient at atol 2e-6 (two frameworks summing in different orders
through two layers) plus 4e-6 of its own largest entry. The second term
is new here: the classification loss is a mean over 2 sequences, not
over the tokens, so its gradients reach 4 (the token-type row sums all
256 positions), not 0.1 as in the GPT and ERNIE tests. Measured: at
most 3.8e-6 apart on the token-type row (largest entry ~3.2), and no
gradient apart by more than 3.1e-6 of its largest entry, but k_proj's
bias, which is zero in exact arithmetic (~1e-8 of noise; the first term
covers it). The 3-step AdamW trajectory at O0 at rtol 1e-5, the JAX
package's own bound for its compiled step, and at O2 at rtol 2e-2 (a
few bf16 ulps of a loss near 0.7: both compute in bf16 with rounding at
different places), with the dtype of every matrix product and of K3's
inputs checked where they are computed.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _torch_helpers import (TINY_ENCODER, jax_state, tiny_text_models,
                            token_batch)
from paddle_tpu.jit.train_step import CompiledTrainStep as JaxTrainStep
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn.layer.common import Linear
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.text import bert

LR = 1e-3
SEQCLS = "BertForSequenceClassification"


@pytest.fixture(autouse=True)
def dense_jax_attention(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "0")


def _np(t):
    return np.asarray(t._value)


def _batch(seed, k=None):
    """ids [2, 128] (or [k, 2, 128]) and one class label per sequence."""
    ids, _ = token_batch(seed, k)
    rng = np.random.default_rng(seed + 1000)
    return ids, rng.integers(0, 2, ids.shape[:-1])


def _count(monkeypatch, name):
    calls = []
    real = getattr(ck, name)
    monkeypatch.setattr(ck, name, lambda *a, **kw: calls.append(
        a[0].dtype) or real(*a, **kw))
    return calls


def _grads_match(pm, jm, skip=()):
    jgrads = {n: np.zeros(p.shape, np.float32) if p.grad is None
              else _np(p.grad) for n, p in jm.named_parameters()}
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        if name.startswith(skip):
            assert g is None and not jgrads[name].any(), name
            continue
        atol = 2e-6 + 4e-6 * float(np.abs(jgrads[name]).max())
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=atol,
                                   rtol=0, err_msg=name)


def test_state_names_are_the_references():
    for head in (SEQCLS, "BertForPretraining"):
        jm, pm = tiny_text_models("bert", head)
        assert sorted(n for n, _ in pm.named_parameters()) == \
            sorted(jax_state(jm))


def test_sequence_classification_forward_loss_and_gradients_match_jax(
        monkeypatch):
    jm, pm = tiny_text_models("bert", SEQCLS)
    pm.train()
    ids, labels = _batch(0)
    fwd = _count(monkeypatch, "flash_attention_values")
    bwd = _count(monkeypatch, "flash_attention_bwd")
    jlogits, jloss = jm(paddle.to_tensor(ids),
                        labels=paddle.to_tensor(labels))
    jloss.backward()
    logits, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    assert len(fwd) == 2 and len(bwd) == 2   # K2 and K3 once per layer
    assert logits.shape == (2, 2)
    np.testing.assert_allclose(logits.detach().numpy(), _np(jlogits),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(loss.item(), float(_np(jloss)), atol=1e-5,
                               rtol=0)
    _grads_match(pm, jm)


def test_padded_batch_matches_jax_on_the_dense_path(monkeypatch):
    jm, pm = tiny_text_models("bert", SEQCLS)
    ids, labels = _batch(1)
    mask = (np.arange(128)[None] < np.array([[50], [128]])).astype(np.int64)
    fwd = _count(monkeypatch, "flash_attention_values")
    jlogits, jloss = jm(paddle.to_tensor(ids),
                        attention_mask=paddle.to_tensor(mask),
                        labels=paddle.to_tensor(labels))
    logits, loss = pm(torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask),
                      labels=torch.from_numpy(labels))
    assert fwd == []
    np.testing.assert_allclose(logits.detach().numpy(), _np(jlogits),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(loss.item(), float(_np(jloss)), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("head", ["BertForTokenClassification",
                                  "BertForQuestionAnswering"])
def test_other_heads_match_jax(head):
    jm, pm = tiny_text_models("bert", head)
    ids, _ = token_batch(2)
    if head == "BertForQuestionAnswering":
        jout = jm(paddle.to_tensor(ids))
        pout = pm(torch.from_numpy(ids))
    else:
        lab = np.random.default_rng(3).integers(0, 2, (2, 128))
        jout = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(lab))
        pout = pm(torch.from_numpy(ids), labels=torch.from_numpy(lab))
    assert len(jout) == len(pout) == 2
    for j, p in zip(jout, pout):
        np.testing.assert_allclose(p.detach().numpy(), _np(j), atol=1e-5,
                                   rtol=0)


def test_pretraining_forward_and_gradients_match_jax():
    jm, pm = tiny_text_models("bert", "BertForPretraining")
    pm.train()
    ids, mlm = token_batch(4)
    nsp = np.array([0, 1])
    jpred, jrel = jm(paddle.to_tensor(ids))
    pred, rel = pm(torch.from_numpy(ids))
    np.testing.assert_allclose(pred.detach().numpy(), _np(jpred), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(rel.detach().numpy(), _np(jrel), atol=1e-5,
                               rtol=0)
    *_, jloss = jm(paddle.to_tensor(ids),
                   masked_lm_labels=paddle.to_tensor(mlm),
                   next_sentence_label=paddle.to_tensor(nsp))
    jloss.backward()
    *_, loss = pm(torch.from_numpy(ids),
                  masked_lm_labels=torch.from_numpy(mlm),
                  next_sentence_label=torch.from_numpy(nsp))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(_np(jloss)), atol=1e-5,
                               rtol=0)
    # the tied decoder's gradient reaches the word embedding
    _grads_match(pm, jm)
    *_, mlm_only = pm(torch.from_numpy(ids),
                      masked_lm_labels=torch.from_numpy(mlm))
    assert float(mlm_only) < float(loss)


def _steps(amp_level):
    jm, pm = tiny_text_models("bert", SEQCLS)
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jstep = JaxTrainStep(lambda i, y: jm(i, labels=y)[1], jm, jopt,
                         amp_level=amp_level, donate=False)
    popt = port_opt.AdamW(learning_rate=LR, parameters=pm.parameters())
    step = CompiledTrainStep(lambda i, y: pm(i, labels=y)[1], pm, popt,
                             amp_level=amp_level)
    want, got = [], []
    for i in range(3):
        ids, labels = _batch(10 + i)
        want.append(float(_np(jstep(paddle.to_tensor(ids),
                                    paddle.to_tensor(labels)))))
        got.append(float(step(torch.from_numpy(ids),
                              torch.from_numpy(labels))))
    return jm, pm, step, want, got


def test_o0_adamw_trajectory_matches_jax():
    jm, pm, _, want, got = _steps("O0")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jparams = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   _np(jparams[name]), atol=3 * LR, rtol=0,
                                   err_msg=name)


def test_o2_trajectory_matches_jax_and_keeps_fp32_params(monkeypatch):
    bwd = _count(monkeypatch, "flash_attention_bwd")
    seen = []
    real_forward = Linear.forward

    def spy(self, x):
        out = real_forward(self, x)
        seen.append((x.dtype, self.weight.dtype, out.dtype))
        return out

    monkeypatch.setattr(Linear, "forward", spy)
    _, pm, step, want, got = _steps("O2")
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert bwd == [torch.bfloat16] * 6   # 2 layers x 3 steps, in bf16
    # 3 steps x (2 layers x 6 Linears + pooler + classifier)
    assert len(seen) == 3 * (2 * 6 + 2)
    assert all(dt == torch.bfloat16 for rec in seen for dt in rec)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    accs = step.optimizer._get_accumulators(pm.classifier.weight)
    assert accs["moment1"].dtype == torch.float32


def test_encoder_layers_start_as_deep_copies():
    pm = bert.BertForSequenceClassification(
        bert.BertConfig(**TINY_ENCODER), device="cpu", seed=1)
    first, second = (dict(layer.named_parameters())
                     for layer in pm.bert.encoder.layers)
    for name, p in first.items():
        assert torch.equal(second[name], p) and second[name] is not p


def test_presets_and_the_device_rule_match_jax():
    from paddle_tpu.text import bert as jbert
    for preset in ("bert_base", "bert_large"):
        assert vars(getattr(bert, preset)()) == vars(getattr(jbert, preset)())
    assert vars(bert.BertConfig()) == vars(jbert.BertConfig())
    cfg = bert.BertConfig(**TINY_ENCODER)
    if torch.cuda.is_available():
        assert bert.BertForSequenceClassification(cfg).classifier.bias.is_cuda
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            bert.BertForSequenceClassification(cfg)
