"""Convolution functionals (counterpart: ``paddle_tpu/nn/functional/
conv.py``): ``conv1d``, ``conv2d`` and ``conv3d``.

On the card these are cuDNN's convolutions (``torch.nn.functional.
conv*d``), the work XLA's ``conv_general_dilated`` does in the JAX
package; no kernel is written by hand here. Padding is an int, a list of
one int per spatial axis, a list of (low, high) pairs or 2n ints, or
``"SAME"``/``"VALID"`` with XLA's meaning (``"SAME"``: output
ceil(size / stride), the odd pad on the high side). Uneven padding pads
``x`` first and convolves with none.

``data_format`` "NCHW" (and "NCL", "NCDHW") takes channels-first tensors;
"NHWC" (and "NLC"/"NWC", "NDHWC") takes channels-last ones, as the
reference's layers do. Channels-last runs as PyTorch's
``channels_last`` memory format: the channels move to axis 1 as a
permuted view, no copy, so cuDNN sees an NHWC tensor, and the result
moves back the same way.

As in the reference, a floating ``x`` takes the weight's dtype first, so
under AMP O2 (bf16 weights) the fp32 images the first convolution
receives are cast and every convolution computes in bf16.

Transposed convolutions are not ported (ROADMAP A10).
"""
from __future__ import annotations

import torch

_CHANNEL_LAST = ("NHWC", "NWC", "NLC", "NDHWC")


def _norm_tuple(v, n):
    if isinstance(v, int):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _norm_padding(padding, n):
    """The reference's padding forms as ``"SAME"``/``"VALID"`` or n
    (low, high) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return ((int(padding), int(padding)),) * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return tuple((int(p), int(p)) for p in padding)
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(n))
    return tuple(tuple(int(q) for q in p) for p in padding)


def _same_pairs(sizes, window, stride):
    """XLA's "SAME": output ceil(size / stride); the total pad splits
    low = total // 2, the rest high."""
    pairs = []
    for s, w, st in zip(sizes, window, stride):
        out = -(-s // st)
        total = max((out - 1) * st + w - s, 0)
        pairs.append((total // 2, total - total // 2))
    return tuple(pairs)


def explicit_pairs(padding, sizes, window, stride):
    """(low, high) per spatial axis for padding already normalized by
    ``_norm_padding``; ``window`` is the dilated extent of the filter."""
    if padding == "VALID":
        return ((0, 0),) * len(sizes)
    if padding == "SAME":
        return _same_pairs(sizes, window, stride)
    return padding


def pad_spatial(x, pairs, value=0.0):
    """``x`` (channels-first) padded by ``pairs`` on its spatial axes."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return torch.nn.functional.pad(x, flat, value=value)


def channels_first(x, data_format):
    """``x`` with its channels on axis 1 (a view for a channels-last
    layout) and whether it was moved."""
    if data_format in _CHANNEL_LAST:
        return x.movedim(-1, 1), True
    return x, False


def restore_layout(y, moved):
    return y.movedim(1, -1) if moved else y


_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format):
    n = x.ndim - 2
    if x.dtype != weight.dtype and x.is_floating_point() and \
            weight.is_floating_point():
        x = x.to(weight.dtype)
    x, moved = channels_first(x, data_format)
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    window = [d * (k - 1) + 1 for d, k in zip(dilation, weight.shape[2:])]
    pairs = explicit_pairs(_norm_padding(padding, n), x.shape[2:], window,
                           stride)
    if all(lo == hi for lo, hi in pairs):
        pad = tuple(lo for lo, _ in pairs)
    else:
        x, pad = pad_spatial(x, pairs), 0
    y = _CONV[n](x, weight, bias, stride, pad, dilation, int(groups))
    return restore_layout(y, moved)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format)


def _transpose_not_ported(*args, **kwargs):
    raise NotImplementedError(
        "transposed convolutions are not ported yet (ROADMAP A10)")


conv1d_transpose = conv2d_transpose = conv3d_transpose = \
    _transpose_not_ported
