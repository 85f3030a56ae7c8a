"""The port's encoder building blocks against the JAX package on shared
numpy inputs and carried weights: ``MultiHeadAttention``,
``TransformerEncoderLayer`` (post-LN and ``normalize_before``) and
``TransformerEncoder``, unmasked and masked; the activations; the common
layers; and ``cross_entropy`` (ignore_index, an all-ignored batch,
``weight``, ``label_smoothing``, reductions).

Widths: hidden 128, 2 heads of 64, sequences of 128, batch 2, so the
port's unmasked attention takes the kernel route (the plain K2/K3 twins
on the CPU); the JAX package runs as its own tests run it on the CPU,
``PDTPU_PALLAS_INTERPRET`` off, so its attention takes the dense path
below 512 tokens.

Tolerances, fp32: outputs at atol 1e-5 and gradients at atol 2e-6 (two
frameworks summing in different orders over 128 keys and 2 x 128
tokens; the cotangents are scaled so the gradients are below 0.1), the
bounds of
``tests/test_torch_train_step.py``; elementwise activations at atol
1e-6; the losses at atol 1e-6 (sums of 256 terms of order 5), their
logit gradients at atol 1e-7 under the mean (entries below 1 / 128) and
2e-6 under sum or none (entries below 1: the two packages' softmax
gradients differ by up to ~6 fp32 ulps of 1, 6.6e-7 measured).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _torch_helpers import jax_state
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import cuda_kernels as ck

B, S, HIDDEN, HEADS, FFN = 2, 128, 128, 2, 256


@pytest.fixture(autouse=True)
def dense_jax_attention(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "0")


def _np(t):
    return np.asarray(t._value)


def _inputs(seed, shape=(B, S, HIDDEN)):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _masks(kind):
    """(JAX mask, port mask) or (None, None): an additive fp32 [b, 1, 1,
    s] mask of -1e4 past each sequence's length (90 and 128 tokens), as
    the models build it, or the same keep pattern as a bool [b, s, s]
    mask."""
    if kind == "none":
        return None, None
    keep = np.arange(S)[None, :] < np.array([[90], [128]])
    if kind == "additive_4d":
        m = ((1.0 - keep[:, None, None, :]) * -1e4).astype(np.float32)
    else:
        m = np.broadcast_to(keep[:, None, :], (B, S, S)).copy()
    return paddle.to_tensor(m), torch.from_numpy(m)


def _kernel_calls(monkeypatch):
    """Record every call of the kernel wrapper the attention takes: the
    operands' contiguity and 16-byte alignment, which the card's bf16
    route needs without a copy."""
    calls = []
    real = ck.flash_attention_values

    def spy(q, k, v, *a, **kw):
        calls.append(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                         for t in (q, k, v)))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(ck, "flash_attention_values", spy)
    return calls


def _run_both(jlayer, player, x, jargs=(), pargs=()):
    """Forward and backward of sum(out * w) in both packages, w standard
    normal over 64 so the gradients stay below 0.1, as a loss's do in the
    train-step tests: (port out, JAX out, port grads by name, JAX grads
    by name, port dx, JAX dx)."""
    w = (np.random.default_rng(99).standard_normal(x.shape) / 64) \
        .astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jlayer(jx, *jargs)
    (jout * paddle.to_tensor(w)).sum().backward()
    px = torch.from_numpy(x).requires_grad_(True)
    pout = player(px, *pargs)
    (pout * torch.from_numpy(w)).sum().backward()
    jgrads = {n: _np(p.grad) for n, p in jlayer.named_parameters()}
    pgrads = {n: p.grad.numpy() for n, p in player.named_parameters()}
    return (pout.detach().numpy(), _np(jout), pgrads, jgrads,
            px.grad.numpy(), _np(jx.grad))


def _assert_layer_matches(got, atol_out=1e-5, atol_grad=2e-6):
    pout, jout, pgrads, jgrads, pdx, jdx = got
    np.testing.assert_allclose(pout, jout, atol=atol_out, rtol=0)
    np.testing.assert_allclose(pdx, jdx, atol=atol_grad, rtol=0)
    assert sorted(pgrads) == sorted(jgrads)
    for name, g in pgrads.items():
        np.testing.assert_allclose(g, jgrads[name], atol=atol_grad, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("mask", ["none", "additive_4d", "bool_3d"])
def test_multi_head_attention_matches_jax(mask, monkeypatch):
    paddle.seed(0)
    jm = paddle.nn.MultiHeadAttention(HIDDEN, HEADS)
    pm = pnn.MultiHeadAttention(HIDDEN, HEADS, device="cpu")
    load_jax_state(pm, jax_state(jm))
    calls = _kernel_calls(monkeypatch)
    jmask, pmask = _masks(mask)
    got = _run_both(jm, pm, _inputs(1), (None, None, jmask),
                    (None, None, pmask))
    _assert_layer_matches(got)
    # unmasked: the kernel route, on q, k, v it takes as they are; masked:
    # the dense path, as in the reference
    assert calls == ([True] if mask == "none" else [])


@pytest.mark.parametrize("mask", ["none", "additive_4d"])
@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_encoder_layer_matches_jax(normalize_before, mask):
    paddle.seed(1)
    kw = dict(dropout=0.0, activation="gelu",
              normalize_before=normalize_before)
    jl = paddle.nn.TransformerEncoderLayer(HIDDEN, HEADS, FFN, **kw)
    pl = pnn.TransformerEncoderLayer(HIDDEN, HEADS, FFN, device="cpu", **kw)
    load_jax_state(pl, jax_state(jl))
    jmask, pmask = _masks(mask)
    _assert_layer_matches(_run_both(jl, pl, _inputs(2), (jmask,),
                                    (pmask,)))


def test_encoder_with_final_norm_matches_jax():
    paddle.seed(2)
    jl = paddle.nn.TransformerEncoderLayer(HIDDEN, HEADS, FFN, dropout=0.0,
                                           normalize_before=True)
    je = paddle.nn.TransformerEncoder(jl, 2, paddle.nn.LayerNorm(HIDDEN))
    pl = pnn.TransformerEncoderLayer(HIDDEN, HEADS, FFN, dropout=0.0,
                                     normalize_before=True, device="cpu")
    pe = pnn.TransformerEncoder(
        pl, 2, torch.nn.LayerNorm(HIDDEN, 1e-5, device="cpu"))
    load_jax_state(pe, jax_state(je))
    _assert_layer_matches(_run_both(je, pe, _inputs(3)))


def test_encoder_layers_start_as_deep_copies_in_both_packages():
    """The reference deep-copies the layer it is given (upstream Paddle
    builds fresh layers); the port follows the reference."""
    paddle.seed(3)
    je = paddle.nn.TransformerEncoder(
        paddle.nn.TransformerEncoderLayer(HIDDEN, HEADS, FFN), 3)
    pe = pnn.TransformerEncoder(
        pnn.TransformerEncoderLayer(HIDDEN, HEADS, FFN, device="cpu"), 3)
    for enc, value in ((je, lambda p: _np(p)),
                       (pe, lambda p: p.detach().numpy())):
        states = [{n: value(p) for n, p in layer.named_parameters()}
                  for layer in enc.layers]
        for other in states[1:]:
            for name, arr in states[0].items():
                np.testing.assert_array_equal(other[name], arr)
    assert pe.layers[0].linear1.weight is not pe.layers[1].linear1.weight


def test_caches_and_param_attrs_are_refused():
    pm = pnn.MultiHeadAttention(HIDDEN, HEADS, device="cpu")
    x = torch.zeros(1, 4, HIDDEN)
    with pytest.raises(NotImplementedError, match="cache"):
        pm(x, cache=object())
    pl = pnn.TransformerEncoderLayer(HIDDEN, HEADS, FFN, device="cpu")
    with pytest.raises(NotImplementedError, match="cache"):
        pl(x, cache=object())
    with pytest.raises(NotImplementedError, match="cache"):
        pnn.TransformerEncoder(pl, 2)(x, cache=[])
    with pytest.raises(NotImplementedError, match="weight_attr"):
        pnn.TransformerEncoderLayer(HIDDEN, HEADS, FFN, bias_attr=False,
                                    device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        pnn.MultiHeadAttention(HIDDEN, 3, device="cpu")


@pytest.mark.parametrize("layer", ["Linear", "Embedding",
                                   "MultiHeadAttention"])
def test_layers_follow_the_device_rule(layer):
    args = {"Linear": (4, 8), "Embedding": (16, 8),
            "MultiHeadAttention": (128, 2)}[layer]
    cls = getattr(pnn, layer)
    assert all(p.device.type == "cpu"
               for p in cls(*args, device="cpu").parameters())
    if torch.cuda.is_available():
        built = cls(*args)
        assert next(built.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cls(*args)


def test_linear_keeps_paddles_layout_and_draws_from_the_generator():
    gen = torch.Generator().manual_seed(5)
    a = pnn.Linear(4, 8, device="cpu", generator=gen)
    b = pnn.Linear(4, 8, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    assert a.weight.shape == (4, 8) and torch.equal(a.weight, b.weight)
    assert torch.equal(a.bias, torch.zeros(8))
    # Xavier uniform over fan_in + fan_out, the reference's default
    assert float(a.weight.abs().max()) <= (6 / 12) ** 0.5
    x = torch.randn(3, 4)
    torch.testing.assert_close(a(x), x @ a.weight, atol=0, rtol=0)
    assert pnn.Linear(4, 8, bias=False, device="cpu").bias is None


def test_embedding_padding_idx_matches_jax():
    paddle.seed(4)
    je = paddle.nn.Embedding(16, 8, padding_idx=-1)
    pe = pnn.Embedding(16, 8, padding_idx=-1, device="cpu")
    assert float(pe.weight[15].abs().max()) == 0.0
    load_jax_state(pe, jax_state(je))
    ids = np.array([[0, 15, 3, 15], [7, 7, 15, 1]])
    jout = je(paddle.to_tensor(ids))
    (jout * jout).sum().backward()
    pout = pe(torch.from_numpy(ids))
    (pout * pout).sum().backward()
    np.testing.assert_array_equal(pout.detach().numpy(), _np(jout))
    np.testing.assert_allclose(pe.weight.grad.numpy(), _np(je.weight.grad),
                               atol=1e-6, rtol=0)
    assert float(pe.weight.grad[15].abs().max()) == 0.0


def test_dropout_modes_and_axis():
    x = torch.ones(4, 6, 8)
    assert torch.equal(pnn.Dropout(0.0)(x), x)
    up, down = pnn.Dropout(0.25), pnn.Dropout(0.25, mode="downscale_in_infer")
    assert torch.equal(up.eval()(x), x)
    assert torch.equal(down.eval()(x), x * 0.75)
    kept = up.train()(x)
    assert set(kept.unique().tolist()) <= {0.0, float(torch.tensor(1 / 0.75))}
    assert set(down.train()(x).unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(pnn.Dropout(1.0)(x), torch.zeros_like(x))
    # one keep decision per (axis 0, axis 2) index, shared along axis 1
    shared = pnn.Dropout(0.5, axis=[0, 2])(x)
    assert torch.equal(shared, shared[:, :1].expand_as(shared))
    with pytest.raises(ValueError, match="mode"):
        pnn.Dropout(0.1, mode="other")


@pytest.mark.parametrize("approximate", [False, True],
                         ids=["erf", "tanh"])
def test_gelu_matches_jax(approximate):
    x = _inputs(6, (1000,)) * 4
    want = _np(paddle.nn.functional.gelu(paddle.to_tensor(x),
                                         approximate=approximate))
    got = PF.gelu(torch.from_numpy(x), approximate=approximate).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_gelu_layer_is_the_exact_form():
    x = torch.from_numpy(_inputs(7, (1000,)) * 4)
    want = _np(paddle.nn.GELU()(paddle.to_tensor(x.numpy())))
    np.testing.assert_allclose(pnn.GELU()(x).numpy(), want, atol=1e-6,
                               rtol=0)
    # the exact and tanh forms differ by more than the bound above, so
    # the check tells them apart
    gap = (pnn.GELU()(x) - pnn.GELU(approximate=True)(x)).abs().max()
    assert float(gap) > 1e-4


@pytest.mark.parametrize("name", ["relu", "tanh"])
def test_activation_matches_jax(name):
    x = _inputs(8, (1000,)) * 4
    want = _np(getattr(paddle.nn.functional, name)(paddle.to_tensor(x)))
    got = getattr(PF, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if name == "tanh":
        np.testing.assert_allclose(pnn.Tanh()(torch.from_numpy(x)).numpy(),
                                   want, atol=1e-6, rtol=0)


CE_CASES = {
    "plain": dict(),
    "ignore_minus_100": dict(ignored=0.5),
    "all_ignored": dict(ignored=1.0),
    "weight": dict(weight=True),
    "weight_ignored": dict(weight=True, ignored=0.5),
    "label_smoothing": dict(kw=dict(label_smoothing=0.1), ignored=0.3),
    "sum": dict(kw=dict(reduction="sum"), ignored=0.3),
    "none": dict(kw=dict(reduction="none"), ignored=0.3),
    "ignore_index_3": dict(kw=dict(ignore_index=3), labels_max=8),
    "out_of_range_label": dict(bad_label=True),
    "probabilities": dict(kw=dict(use_softmax=False), probs=True),
    "label_class_axis": dict(class_axis=True),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_matches_jax(case):
    spec = CE_CASES[case]
    rng = np.random.default_rng(10)
    n, c = 256, 32
    logits = rng.standard_normal((n, c)).astype(np.float32) * 3
    if spec.get("probs"):
        e = np.exp(logits)
        logits = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    labels = rng.integers(0, spec.get("labels_max", c), n)
    labels[rng.random(n) < spec.get("ignored", 0.0)] = -100
    if spec.get("bad_label"):
        labels[:4] = [c, c + 5, -3, 2 * c]   # clipped into range
    if spec.get("class_axis"):
        labels = labels[:, None]
    kw = dict(spec.get("kw", {}))
    jkw, pkw = dict(kw), dict(kw)
    if spec.get("weight"):
        w = rng.uniform(0.5, 2.0, c).astype(np.float32)
        jkw["weight"], pkw["weight"] = paddle.to_tensor(w), \
            torch.from_numpy(w)
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jloss = paddle.nn.functional.cross_entropy(jx, paddle.to_tensor(labels),
                                               **jkw)
    px = torch.from_numpy(logits).requires_grad_(True)
    ploss = PF.cross_entropy(px, torch.from_numpy(labels), **pkw)
    np.testing.assert_allclose(ploss.detach().numpy(), _np(jloss),
                               atol=1e-6, rtol=0)
    jloss.sum().backward()
    ploss.sum().backward()
    mean = kw.get("reduction", "mean") == "mean"
    np.testing.assert_allclose(px.grad.numpy(), _np(jx.grad),
                               atol=1e-7 if mean else 2e-6, rtol=0)
    if case == "all_ignored":
        # the reference's max(count, 1): 0 and zero gradients, where
        # torch.nn.functional.cross_entropy gives NaN
        assert float(ploss) == 0.0 and float(px.grad.abs().max()) == 0.0
        assert torch.isnan(torch.nn.functional.cross_entropy(
            px.detach(), torch.from_numpy(labels)))


def test_cross_entropy_refuses_soft_labels():
    x = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError, match="later slice"):
        PF.cross_entropy(x, torch.full((4, 3), 1 / 3))
    with pytest.raises(NotImplementedError, match="later slice"):
        PF.cross_entropy(x, torch.zeros(4, 1), soft_label=True)
