"""Activation functionals (counterpart: ``paddle_tpu/nn/functional/
activation.py``). ``gelu`` is the exact erf form unless ``approximate``
is set, as in the reference (the GPT takes the tanh form), and goes
through the per-op seam (``ops/dispatch.py``) as op "gelu"; the encoders'
layers look these functions up by name (``TransformerEncoderLayer``'s
``activation``)."""
from __future__ import annotations

import torch

from ...ops.common import ensure_tensor, single_axis
from ...ops.dispatch import dispatch
from ...tensor import Tensor


def _gelu_impl(x, approximate):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    return dispatch("gelu", _gelu_impl, x, approximate=bool(approximate))


def _plain(fn, x):
    """``fn`` as the models call it on torch tensors (no seam), wrapped
    around a paddle Tensor's value."""
    if isinstance(x, Tensor):
        return Tensor._wrap(fn(x._value))
    return fn(x)


def relu(x, name=None):
    return _plain(torch.relu, x)


def tanh(x, name=None):
    return _plain(torch.tanh, x)


# the rest of the reference's activations, each through the per-op seam
# under its op name
_TF = torch.nn.functional


def _act(op_name, impl, x, **attrs):
    return dispatch(op_name, impl, ensure_tensor(x), **attrs)


def relu6(x, name=None):
    return _act("relu6", lambda v: torch.clamp(v, 0.0, 6.0), x)


def sigmoid(x, name=None):
    return _act("sigmoid", torch.sigmoid, x)


def silu(x, name=None):
    return _act("silu", _TF.silu, x)


swish = silu


def mish(x, name=None):
    return _act("mish", _TF.mish, x)


def _softplus_impl(x, beta, threshold):
    bx = beta * x
    return torch.where(bx > threshold, x, torch.log1p(torch.exp(bx)) / beta)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _act("softplus", _softplus_impl, x, beta=float(beta),
                threshold=float(threshold))


def softsign(x, name=None):
    return _act("softsign", _TF.softsign, x)


def tanhshrink(x, name=None):
    return _act("tanhshrink", lambda v: v - torch.tanh(v), x)


def _hardtanh_impl(x, min, max):
    return torch.clamp(x, min, max)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _act("hardtanh", _hardtanh_impl, x, min=float(min),
                max=float(max))


def hardswish(x, name=None):
    return _act("hardswish",
                lambda v: v * torch.clamp(v + 3.0, 0.0, 6.0) / 6.0, x)


def _hardsigmoid_impl(x, slope, offset):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return _act("hardsigmoid", _hardsigmoid_impl, x, slope=float(slope),
                offset=float(offset))


def elu(x, alpha=1.0, name=None):
    return _act("elu", _TF.elu, x, alpha=float(alpha))


def _selu_impl(x, scale, alpha):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _act("selu", _selu_impl, x, scale=float(scale),
                alpha=float(alpha))


def celu(x, alpha=1.0, name=None):
    return _act("celu", _TF.celu, x, alpha=float(alpha))


def leaky_relu(x, negative_slope=0.01, name=None):
    return _act("leaky_relu", _TF.leaky_relu, x,
                negative_slope=float(negative_slope))


def log_sigmoid(x, name=None):
    return _act("log_sigmoid", _TF.logsigmoid, x)


def _softmax(op_name, impl, x, axis, dtype):
    x = ensure_tensor(x)
    if dtype is not None:
        from ...ops.manipulation import cast
        x = cast(x, dtype)
    return dispatch(op_name, impl, x, dim=single_axis(axis, x.ndim))


def softmax(x, axis=-1, dtype=None, name=None):
    return _softmax("softmax", torch.softmax, x, axis, dtype)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return _softmax("log_softmax", torch.log_softmax, x, axis, dtype)
