"""Convolution layers (counterpart: ``paddle_tpu/nn/layer/conv.py``):
``Conv1D``, ``Conv2D`` and ``Conv3D``.

The weight is [out, in / groups, *kernel], the reference's layout and
PyTorch's, so ``convert.py`` carries it across without a transpose. It is
drawn Xavier-uniform with the reference's fans (fan_in = in / groups x
kernel, fan_out = out x kernel), the bias starts at zero; both are drawn
on the CPU from ``generator`` and moved to the layer's device, as in
``common.py``. ``bias_attr=False`` drops the bias; other attributes are
not ported. Transposed convolutions are not ported (ROADMAP A10).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F
from .common import _param


def _ntuple(v, n):
    if isinstance(v, int):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _xavier_conv(shape, generator):
    receptive = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


class _ConvNd(nn.Module):
    _fn = None

    def __init__(self, ndim, in_channels, out_channels, kernel_size,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", device=None, dtype=None,
                 generator=None):
        super().__init__()
        if padding_mode != "zeros" or weight_attr is not None or \
                bias_attr not in (None, False):
            raise NotImplementedError(
                "padding_mode, weight_attr and bias_attr other than the "
                "defaults (bias_attr=False drops the bias) are not ported")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, ndim)
        self._stride = _ntuple(stride, ndim)
        self._padding = padding
        self._dilation = _ntuple(dilation, ndim)
        self._groups = groups
        self._data_format = data_format
        shape = (out_channels, in_channels // groups, *self._kernel_size)
        self.weight = _param(_xavier_conv(shape, generator), device, dtype)
        self.bias = None if bias_attr is False else \
            _param(torch.zeros(out_channels), device, dtype)

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    _fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, dtype=None, generator=None):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device, dtype,
                         generator)


class Conv2D(_ConvNd):
    _fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None, generator=None):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device, dtype,
                         generator)


class Conv3D(_ConvNd):
    _fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, dtype=None, generator=None):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device, dtype,
                         generator)
