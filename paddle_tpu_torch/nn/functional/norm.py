"""Normalization functionals (counterpart: ``paddle_tpu/nn/functional/
norm.py``): ``batch_norm``, ``layer_norm`` and ``rms_norm``.

``layer_norm`` and ``rms_norm`` go through the per-op seam
(``ops/dispatch.py``) under the reference's op names: an ``auto_cast``
block runs ``layer_norm`` in fp32 (the black list), and ``rms_norm``,
on neither list, follows its inputs under O1 and takes the low dtype
under O2. ``rms_norm`` computes in its input's dtype with the reference's
epsilon (1e-6): x * rsqrt(mean(x²) + eps), times the weight; no kernel is
written for it (the reference has no ``pallas_call`` for it either).

``batch_norm``:

On the card this is cuDNN's batch norm (``torch.nn.functional.
batch_norm``), the work the JAX package leaves to XLA; no kernel is
written by hand here. The semantics are the reference's:

- In training (``training`` and not ``use_global_stats``) the batch's
  statistics normalize ``x``, and the running ones move as Paddle moves
  them: ``running = momentum * running + (1 - momentum) * batch``, with
  the unbiased batch variance (``var * n / (n - 1)``). PyTorch's
  ``momentum`` weighs the batch instead, so it is given ``1 - momentum``.
  The running statistics are updated in place, outside autograd.
- Otherwise the running statistics normalize ``x``.
- The statistics stay fp32 and the output takes ``x``'s dtype, so bf16
  activations under AMP O2 stay bf16. O2 casts the scale and shift to
  bf16 with every other parameter; they are widened back to the
  statistics' dtype here (a few hundred values), since PyTorch's
  mixed-dtype batch norm wants them beside the fp32 statistics.

In bf16 the JAX forward rounds its per-channel scale and shift to bf16
and applies one bf16 FMA per element, where cuDNN rounds once, so bf16
outputs differ within bf16's rounding while fp32 ones agree (ROADMAP C).
"""
from __future__ import annotations

import torch

from ...ops.dispatch import dispatch
from .conv import channels_first, restore_layout


def _layer_norm_impl(x, weight, bias, normalized_shape, epsilon):
    return torch.nn.functional.layer_norm(x, normalized_shape, weight, bias,
                                          epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return dispatch("layer_norm", _layer_norm_impl, x, weight, bias,
                    normalized_shape=tuple(normalized_shape),
                    epsilon=float(epsilon))


def _rms_impl(x, weight, eps):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return out if weight is None else out * weight


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    return dispatch("rms_norm", _rms_impl, x, weight, eps=float(epsilon))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    if use_global_stats is None:
        use_global_stats = not training
    moved = False
    if x.ndim > 2:
        x, moved = channels_first(x, data_format)
    stats = running_mean.dtype
    if weight is not None and weight.dtype != stats:
        weight = weight.to(stats)
    if bias is not None and bias.dtype != stats:
        bias = bias.to(stats)
    y = torch.nn.functional.batch_norm(
        x, running_mean, running_var, weight, bias,
        training=bool(training and not use_global_stats),
        momentum=1.0 - float(momentum), eps=float(epsilon))
    return restore_layout(y, moved)
