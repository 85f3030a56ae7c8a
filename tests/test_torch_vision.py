"""The port's vision building blocks against the JAX package on seeded
numpy inputs: ``conv1d/2d/3d`` (stride, padding as an int, a list,
pairs and strings, groups, dilation, channels-last, the AMP O2 cast),
``batch_norm`` in training and eval mode with its running statistics
after 1 and 3 steps, the pools (``exclusive``, ``ceil_mode``, string
and uneven padding, adaptive pooling at sizes that do not divide), the
layers built from them, LeNet's eager (DyGraph) step with Adam, and
``convert.load_jax_state`` over ResNet-50's 267 names.

Tolerances, fp32: convolutions at atol 1e-5 of outputs of order 1 (sums
of up to 3 x 3 x 16 products taken in different orders) and their
gradients at atol 2e-5; batch norm outputs and gradients at atol 1e-5,
the running statistics at atol 1e-6 (their last rounding: PyTorch weighs
old and new as 0.1 and 1 - 0.1, the reference as 0.9 and 0.1); pools at
atol 1e-6 (a max is exact; an average of up to 9 terms). In bf16, batch
norm's outputs agree within 2 ulps of bf16 at the output's largest
entry (the JAX forward rounds its per-channel scale and shift to bf16
before one bf16 FMA per element, PyTorch rounds once; 1.04 ulps
measured over 5 seeds at [8, 16, 14, 14], about half the outputs
differing).
LeNet's step at atol 1e-5 (parameters after Adam at lr 1e-3).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _torch_helpers import jax_state
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision.models import LeNet, resnet50

BF16_ULP = 2.0 ** -7


def _np(t):
    return np.asarray(t._value)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _grad_pair(jfn, pfn, arrays, cot_seed=99):
    """(JAX outputs, port outputs, JAX grads, port grads) of
    sum(out * cotangent) for the numpy ``arrays`` fed to both."""
    jin = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    pin = [torch.from_numpy(a).requires_grad_() for a in arrays]
    jout, pout = jfn(*jin), pfn(*pin)
    cot = _rand(cot_seed, *pout.shape)
    (jout * paddle.to_tensor(cot)).sum().backward()
    (pout * torch.from_numpy(cot)).sum().backward()
    return (_np(jout), pout.detach().numpy(), [_np(t.grad) for t in jin],
            [t.grad.numpy() for t in pin])


# -- convolution --------------------------------------------------------------
CONV_CASES = {
    "plain": dict(),
    "stride2_pad1": dict(stride=2, padding=1),
    "list_padding": dict(padding=[1, 2]),
    "pairs": dict(padding=[[0, 1], [2, 1]]),
    "flat_pairs": dict(padding=[1, 0, 0, 2], stride=[2, 1]),
    "same_stride2": dict(padding="SAME", stride=2),
    "valid": dict(padding="VALID", stride=(1, 2)),
    "groups": dict(groups=2, padding=1),
    "dilation": dict(dilation=2, padding=2),
    "nhwc": dict(padding=1, stride=2, data_format="NHWC"),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case):
    kw = CONV_CASES[case]
    groups = kw.get("groups", 1)
    x = _rand(0, 2, 4, 9, 11)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w, b = _rand(1, 6, 4 // groups, 3, 3), _rand(2, 6)
    jo, po, jg, pg = _grad_pair(
        lambda *t: JF.conv2d(*t, **kw), lambda *t: PF.conv2d(*t, **kw),
        [x, w, b])
    assert po.shape == jo.shape
    np.testing.assert_allclose(po, jo, atol=1e-5, rtol=0)
    for g, want in zip(pg, jg):
        np.testing.assert_allclose(g, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("ndim,fmt", [(1, "NCL"), (1, "NLC"),
                                      (3, "NCDHW"), (3, "NDHWC")])
def test_conv1d_conv3d_match_jax(ndim, fmt):
    spatial = (10,) if ndim == 1 else (5, 6, 7)
    x = _rand(3, 2, 3, *spatial)
    if fmt in ("NLC", "NDHWC"):
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    w = _rand(4, 5, 3, *(3,) * ndim)
    kw = dict(stride=2, padding=1, data_format=fmt)
    name = f"conv{ndim}d"
    jo = _np(getattr(JF, name)(paddle.to_tensor(x), paddle.to_tensor(w),
                               **kw))
    po = getattr(PF, name)(torch.from_numpy(x), torch.from_numpy(w), **kw)
    np.testing.assert_allclose(po.numpy(), jo, atol=1e-5, rtol=0)


def test_conv_o2_cast_takes_the_weights_dtype():
    # fp32 images into a bf16 convolution: both packages cast x first and
    # compute in bf16
    x, w = _rand(5, 2, 3, 8, 8), _rand(6, 4, 3, 3, 3)
    jw = paddle.to_tensor(w).astype("bfloat16")
    jo = _np(JF.conv2d(paddle.to_tensor(x), jw, padding=1).astype("float32"))
    po = PF.conv2d(torch.from_numpy(x), torch.from_numpy(w).bfloat16(),
                   padding=1)
    assert po.dtype == torch.bfloat16
    # bf16 products summed over 27 terms, rounded once: within 2 ulps of
    # bf16 at the output's scale
    scale = float(np.abs(jo).max())
    np.testing.assert_allclose(po.float().numpy(), jo,
                               atol=2 * BF16_ULP * scale, rtol=0)


def test_transposed_conv_is_not_ported():
    with pytest.raises(NotImplementedError, match="A10"):
        PF.conv2d_transpose(torch.zeros(1, 1, 2, 2), torch.zeros(1, 1, 1, 1))


def test_conv2d_layer_init_and_shapes():
    gen = torch.Generator().manual_seed(0)
    layer = pnn.Conv2D(8, 16, 3, groups=2, device="cpu", generator=gen)
    assert tuple(layer.weight.shape) == (16, 4, 3, 3)
    limit = math.sqrt(6.0 / (4 * 9 + 16 * 9))   # the reference's fans
    assert float(layer.weight.abs().max()) <= limit
    assert float(layer.weight.abs().max()) > 0.9 * limit
    assert not layer.bias.any()
    assert pnn.Conv2D(3, 4, 1, bias_attr=False, device="cpu").bias is None
    y = layer(torch.zeros(1, 8, 5, 5))
    assert tuple(y.shape) == (1, 16, 3, 3)


# -- batch norm ---------------------------------------------------------------
def _bn_both(x, training, steps, fmt="NCHW", momentum=0.9, seed=7):
    """Outputs of ``steps`` batch norms of x (+ i each step), gradients of
    the last, and the running statistics after them, in both packages."""
    c = x.shape[1] if fmt == "NCHW" else x.shape[-1]
    w, b = _rand(seed, c) + 1.0, _rand(seed + 1, c)
    rm0, rv0 = _rand(seed + 2, c), np.abs(_rand(seed + 3, c)) + 0.5
    jrm, jrv = paddle.to_tensor(rm0), paddle.to_tensor(rv0)
    prm, prv = torch.from_numpy(rm0.copy()), torch.from_numpy(rv0.copy())
    for i in range(steps):
        xi = x + np.float32(i)
        jo, po, jg, pg = _grad_pair(
            lambda xx, ww, bb: JF.batch_norm(
                xx, jrm, jrv, ww, bb, training=training, momentum=momentum,
                data_format=fmt),
            lambda xx, ww, bb: PF.batch_norm(
                xx, prm, prv, ww, bb, training=training, momentum=momentum,
                data_format=fmt),
            [xi, w, b], cot_seed=seed + i)
    return (jo, po, jg, pg, (_np(jrm), _np(jrv)),
            (prm.numpy(), prv.numpy()))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(training, steps):
    x = _rand(10, 4, 6, 5, 5) * 3.0 + 1.5
    jo, po, jg, pg, jstats, pstats = _bn_both(x, training, steps)
    np.testing.assert_allclose(po, jo, atol=1e-5, rtol=0)
    for g, want in zip(pg, jg):
        np.testing.assert_allclose(g, want, atol=1e-5, rtol=1e-5)
    for got, want in zip(pstats, jstats):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_batch_norm_running_statistics_follow_paddle_momentum():
    # running = m * running + (1 - m) * batch, with the unbiased variance
    x = _rand(11, 8, 3, 4, 4)
    rm, rv = torch.zeros(3), torch.ones(3)
    PF.batch_norm(torch.from_numpy(x), rm, rv, training=True, momentum=0.8)
    n = 8 * 4 * 4
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3)) * n / (n - 1)
    np.testing.assert_allclose(rm.numpy(), 0.2 * mean, atol=1e-6)
    np.testing.assert_allclose(rv.numpy(), 0.8 + 0.2 * var, atol=1e-6)


def test_batch_norm_channels_last_and_2d():
    x = np.ascontiguousarray(_rand(12, 4, 6, 5, 5).transpose(0, 2, 3, 1))
    jo, po, jg, pg, jstats, pstats = _bn_both(x, True, 1, fmt="NHWC")
    np.testing.assert_allclose(po, jo, atol=1e-5, rtol=0)
    for got, want in zip(pstats, jstats):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    x2 = _rand(13, 16, 6)
    jo, po, *_ = _bn_both(x2, True, 1)
    np.testing.assert_allclose(po, jo, atol=1e-5, rtol=0)


def test_batch_norm_bf16_within_bf16_rounding():
    x = _rand(14, 4, 6, 5, 5) * 2.0 + 0.5
    w, b = _rand(15, 6) + 1.0, _rand(16, 6)
    jrm, jrv = paddle.to_tensor(np.zeros(6, np.float32)), \
        paddle.to_tensor(np.ones(6, np.float32))
    prm, prv = torch.zeros(6), torch.ones(6)
    jo = JF.batch_norm(paddle.to_tensor(x).astype("bfloat16"), jrm, jrv,
                       paddle.to_tensor(w).astype("bfloat16"),
                       paddle.to_tensor(b).astype("bfloat16"),
                       training=True)
    po = PF.batch_norm(torch.from_numpy(x).bfloat16(), prm, prv,
                       torch.from_numpy(w).bfloat16(),
                       torch.from_numpy(b).bfloat16(), training=True)
    assert po.dtype == torch.bfloat16 and prm.dtype == torch.float32
    want = _np(jo.astype("float32"))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(po.float().numpy(), want,
                               atol=2 * BF16_ULP * scale, rtol=0)
    # the statistics are fp32 sums of the same bf16 inputs
    np.testing.assert_allclose(prm.numpy(), _np(jrm), atol=1e-6)
    np.testing.assert_allclose(prv.numpy(), _np(jrv), atol=1e-5)


def test_batch_norm_layer_state_names_and_eval():
    layer = pnn.BatchNorm2D(5, device="cpu")
    assert list(dict(layer.named_buffers())) == ["_mean", "_variance"]
    assert layer._mean.dtype == layer._variance.dtype == torch.float32
    assert not layer._mean.any() and bool((layer._variance == 1).all())
    assert bool((layer.weight == 1).all()) and not layer.bias.any()
    x = torch.from_numpy(_rand(17, 4, 5, 3, 3))
    layer(x)
    assert layer._mean.abs().sum() > 0
    stats = (layer._mean.clone(), layer._variance.clone())
    layer.eval()
    y = layer(x)
    assert torch.equal(stats[0], layer._mean)     # eval leaves them alone
    want = (x - stats[0][:, None, None]) / torch.sqrt(
        stats[1][:, None, None] + 1e-5)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=0)
    # SyncBatchNorm in a world of one process is this layer, exactly
    sync = pnn.SyncBatchNorm(5, device="cpu")
    fresh = pnn.BatchNorm2D(5, device="cpu")
    assert torch.equal(sync(x), fresh(x))
    assert torch.equal(sync._mean, fresh._mean)
    assert torch.equal(sync._variance, fresh._variance)


# -- pooling ------------------------------------------------------------------
POOL_CASES = {
    "max_k3s2p1": ("max_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    "max_k2": ("max_pool2d", dict(kernel_size=2)),
    "max_same": ("max_pool2d", dict(kernel_size=3, stride=2,
                                    padding="SAME")),
    "max_uneven": ("max_pool2d", dict(kernel_size=3, stride=2,
                                      padding=[[0, 2], [1, 1]])),
    "max_ceil_mode": ("max_pool2d", dict(kernel_size=2, stride=2,
                                         ceil_mode=True)),
    "max_nhwc": ("max_pool2d", dict(kernel_size=3, stride=2, padding=1,
                                    data_format="NHWC")),
    "avg_exclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                         padding=1)),
    "avg_inclusive": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                         padding=1, exclusive=False)),
    "avg_uneven_exclusive": ("avg_pool2d", dict(kernel_size=3, stride=1,
                                                padding=[0, 2, 1, 0])),
    "avg_big_padding": ("avg_pool2d", dict(kernel_size=2, stride=2,
                                           padding=2)),
    "avg_same": ("avg_pool2d", dict(kernel_size=3, stride=2,
                                    padding="SAME")),
    "avg_valid_ceil": ("avg_pool2d", dict(kernel_size=2, ceil_mode=True,
                                          padding="VALID")),
    "max1d": ("max_pool1d", dict(kernel_size=3, stride=2, padding=1)),
    "avg1d": ("avg_pool1d", dict(kernel_size=3, stride=2, padding=1)),
    "adaptive_avg_7_to_3": ("adaptive_avg_pool2d", dict(output_size=3)),
    "adaptive_avg_to_1": ("adaptive_avg_pool2d", dict(output_size=1)),
    "adaptive_avg_5x7_to_3x2": ("adaptive_avg_pool2d",
                                dict(output_size=(3, 2))),
    "adaptive_avg_up": ("adaptive_avg_pool2d", dict(output_size=(9, 4))),
    "adaptive_avg_nhwc": ("adaptive_avg_pool2d",
                          dict(output_size=3, data_format="NHWC")),
    "adaptive_max_7_to_3": ("adaptive_max_pool2d", dict(output_size=3)),
    "adaptive_avg1d": ("adaptive_avg_pool1d", dict(output_size=4)),
    "adaptive_max1d": ("adaptive_max_pool1d", dict(output_size=4)),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pools_match_jax(case):
    name, kw = POOL_CASES[case]
    x = _rand(20, 2, 3, 7, 7)
    if "5x7" in case:
        x = _rand(20, 2, 3, 5, 7)
    if name.endswith("1d"):
        x = _rand(20, 2, 3, 11)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    jo, po, jg, pg = _grad_pair(lambda t: getattr(JF, name)(t, **kw),
                                lambda t: getattr(PF, name)(t, **kw), [x])
    assert po.shape == jo.shape, (po.shape, jo.shape)
    np.testing.assert_allclose(po, jo, atol=1e-6, rtol=0)
    np.testing.assert_allclose(pg[0], jg[0], atol=1e-6, rtol=0)


def test_ceil_mode_keeps_the_floor_size_as_the_reference():
    # ROADMAP C: both packages ignore ceil_mode (upstream Paddle rounds
    # the output size up); the port follows the JAX package
    y = PF.max_pool2d(torch.zeros(1, 1, 5, 5), 2, 2, ceil_mode=True)
    assert tuple(y.shape) == (1, 1, 2, 2)
    assert tuple(JF.max_pool2d(paddle.zeros([1, 1, 5, 5]), 2, 2,
                               ceil_mode=True).shape) == (1, 1, 2, 2)


def test_pool_layers_and_refusals():
    x = torch.from_numpy(_rand(21, 2, 3, 8, 8))
    torch.testing.assert_close(pnn.MaxPool2D(3, stride=2, padding=1)(x),
                               PF.max_pool2d(x, 3, 2, 1))
    torch.testing.assert_close(pnn.AvgPool2D(2, exclusive=False)(x),
                               PF.avg_pool2d(x, 2, exclusive=False))
    torch.testing.assert_close(pnn.AdaptiveAvgPool2D((1, 1))(x),
                               x.mean((2, 3), keepdim=True))
    assert tuple(pnn.AdaptiveMaxPool1D(3)(x[:, :, 0]).shape) == (2, 3, 3)
    with pytest.raises(NotImplementedError, match="A10"):
        PF.max_pool2d(x, 2, return_mask=True)


# -- containers, activations --------------------------------------------------
def test_sequential_names_and_flatten():
    seq = pnn.Sequential(pnn.ReLU(), pnn.Flatten())
    assert [n for n, _ in seq.named_children()] == ["0", "1"]
    named = pnn.Sequential([("conv", pnn.Conv2D(1, 2, 1, device="cpu")),
                            ("act", pnn.ReLU())])
    assert list(dict(named.named_parameters())) == ["conv.weight",
                                                    "conv.bias"]
    assert isinstance(named[1], pnn.ReLU) and len(named) == 2
    x = torch.from_numpy(_rand(22, 2, 3, 4, 5))
    assert tuple(seq(x).shape) == (2, 60)
    assert bool((seq(x) >= 0).all())
    assert tuple(pnn.Flatten(1, 2)(x).shape) == (2, 12, 5)


# -- LeNet --------------------------------------------------------------------
def test_lenet_dygraph_adam_step_matches_jax():
    from paddle_tpu.vision.models import LeNet as JLeNet
    paddle.seed(3)
    jm = JLeNet(num_classes=10)
    pm = LeNet(num_classes=10, device="cpu")
    load_jax_state(pm, jax_state(jm))
    rng = np.random.default_rng(3)
    jopt = paddle.optimizer.Adam(learning_rate=1e-3,
                                 parameters=jm.parameters())
    popt = port_opt.Adam(learning_rate=1e-3, parameters=pm.parameters())
    jloss_fn, ploss_fn = paddle.nn.CrossEntropyLoss(), pnn.CrossEntropyLoss()
    for _ in range(2):
        x = rng.uniform(0, 1, (8, 1, 28, 28)).astype(np.float32)
        y = rng.integers(0, 10, (8,))
        jloss = jloss_fn(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        ploss = ploss_fn(pm(torch.from_numpy(x)), torch.from_numpy(y))
        jloss.backward()
        ploss.backward()
        jopt.step()
        jopt.clear_grad()
        popt.step()
        popt.clear_grad()
        assert abs(float(ploss) - float(_np(jloss))) <= 1e-5
    jparams = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _np(jparams[name]),
                                   atol=1e-5, rtol=0, err_msg=name)


# -- convert ------------------------------------------------------------------
@pytest.fixture(scope="module")
def resnet50_state():
    from paddle_tpu.vision.models import resnet50 as jresnet50
    paddle.seed(0)
    return jax_state(jresnet50(num_classes=1000))


def test_load_jax_state_carries_resnet50_with_buffers(resnet50_state):
    state = resnet50_state
    assert len(state) == 267
    assert state["fc.weight"].shape == (2048, 1000)
    assert state["conv1.weight"].shape == (64, 3, 7, 7)
    pm = resnet50(num_classes=1000, device="cpu")
    assert sorted(pm.state_dict()) == sorted(state)
    params = dict(pm.named_parameters())
    assert len(params) == 161
    assert sum(p.numel() for p in params.values()) == 25_557_032
    assert len(dict(pm.named_buffers())) == 106
    # the running statistics differ from their fresh values only after
    # a step: give them values to carry
    state = dict(state, **{"layer1.0.downsample.1._mean":
                           np.arange(256, dtype=np.float32)})
    load_jax_state(pm, state)
    for name, t in pm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), state[name], err_msg=name)


def test_load_jax_state_errors(resnet50_state):
    pm = resnet50(num_classes=1000, device="cpu")
    missing = {k: v for k, v in resnet50_state.items()
               if k != "bn1._variance"}
    with pytest.raises(KeyError, match="missing.*bn1._variance"):
        load_jax_state(pm, missing)
    with pytest.raises(KeyError, match="unexpected.*extra"):
        load_jax_state(pm, dict(resnet50_state, extra=np.zeros(1)))
    bad = dict(resnet50_state, **{"bn1._mean": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="bn1._mean"):
        load_jax_state(pm, bad)


def test_vision_models_follow_the_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the rule's error shows only without a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LeNet()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pnn.BatchNorm2D(4)
    with pytest.raises(NotImplementedError, match="pretrained"):
        resnet50(pretrained=True, device="cpu")
