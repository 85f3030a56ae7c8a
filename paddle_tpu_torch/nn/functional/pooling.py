"""Pooling functionals (counterpart: ``paddle_tpu/nn/functional/
pooling.py``): max and average pooling over 1 to 3 spatial axes, and
their adaptive forms.

On the card these are ATen's pooling kernels, the work
``lax.reduce_window`` does in the JAX package. The reference's rules:

- ``stride`` defaults to the window; padding takes the forms of
  ``conv.py`` (an int, per-axis ints, (low, high) pairs, ``"SAME"``,
  ``"VALID"``).
- Max pooling pads with -inf, so a padded position never wins.
- Average pooling with ``exclusive=True`` (the default) divides each
  window's sum by the positions inside the input (PyTorch's
  ``count_include_pad=False``); with ``exclusive=False``, and with string
  padding, by the window's size.
- ``ceil_mode`` is accepted and, as in the reference, does not change
  the output's size: windows always fit inside the padded input
  (ROADMAP C records that upstream Paddle rounds up instead).
- Adaptive pooling gives bin j the input range [floor(j s / o),
  ceil((j + 1) s / o)), which is PyTorch's rule as well.

Padding that PyTorch's pools cannot take (uneven, or more than half the
window) is applied first, with -inf or zeros. ``return_mask=True`` is not
ported (ROADMAP A10).
"""
from __future__ import annotations

import torch

from .conv import (_norm_padding, _norm_tuple, channels_first,
                   explicit_pairs, pad_spatial, restore_layout)

_F = torch.nn.functional
_MAX = {1: _F.max_pool1d, 2: _F.max_pool2d, 3: _F.max_pool3d}
_AVG = {1: _F.avg_pool1d, 2: _F.avg_pool2d, 3: _F.avg_pool3d}
_ADAPTIVE = {("avg", 1): _F.adaptive_avg_pool1d,
             ("avg", 2): _F.adaptive_avg_pool2d,
             ("avg", 3): _F.adaptive_avg_pool3d,
             ("max", 1): _F.adaptive_max_pool1d,
             ("max", 2): _F.adaptive_max_pool2d,
             ("max", 3): _F.adaptive_max_pool3d}


def _no_mask(return_mask):
    if return_mask:
        raise NotImplementedError(
            "pooling with return_mask=True is not ported yet (ROADMAP A10)")


def _pool(kind, x, kernel_size, stride, padding, data_format,
          exclusive=True):
    n = x.ndim - 2
    ksize = _norm_tuple(kernel_size, n)
    stride = ksize if stride is None else _norm_tuple(stride, n)
    norm = _norm_padding(padding, n)
    x, moved = channels_first(x, data_format)
    pairs = explicit_pairs(norm, x.shape[2:], ksize, stride)
    native = all(lo == hi and lo <= k // 2
                 for (lo, hi), k in zip(pairs, ksize))
    pad = tuple(lo for lo, _ in pairs)
    if kind == "max":
        if not native:
            x, pad = pad_spatial(x, pairs, float("-inf")), 0
        y = _MAX[n](x, ksize, stride, pad)
    else:
        # string padding divides by the window's size, as the reference
        exclusive = exclusive and not isinstance(norm, str)
        if native:
            y = _AVG[n](x, ksize, stride, pad,
                        count_include_pad=not exclusive)
        else:
            y = _AVG[n](pad_spatial(x, pairs), ksize, stride, 0)
            if exclusive and any(lo or hi for lo, hi in pairs):
                ones = torch.ones((1, 1) + tuple(x.shape[2:]),
                                  dtype=x.dtype, device=x.device)
                y = y / _AVG[n](pad_spatial(ones, pairs), ksize, stride, 0)
    return restore_layout(y, moved)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    _no_mask(return_mask)
    return _pool("max", x, kernel_size, stride, padding, data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    _no_mask(return_mask)
    return _pool("max", x, kernel_size, stride, padding, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    _no_mask(return_mask)
    return _pool("max", x, kernel_size, stride, padding, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool("avg", x, kernel_size, stride, padding, data_format,
                 exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool("avg", x, kernel_size, stride, padding, data_format,
                 exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool("avg", x, kernel_size, stride, padding, data_format,
                 exclusive)


def _adaptive(kind, x, output_size, data_format):
    n = x.ndim - 2
    out = _norm_tuple(output_size, n)
    x, moved = channels_first(x, data_format)
    return restore_layout(_ADAPTIVE[kind, n](x, out), moved)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive("avg", x, output_size, "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive("avg", x, output_size, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive("avg", x, output_size, data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask)
    return _adaptive("max", x, output_size, "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask)
    return _adaptive("max", x, output_size, "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask)
    return _adaptive("max", x, output_size, "NCDHW")

