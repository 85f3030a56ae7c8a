"""Normalization functionals (counterpart: ``paddle_tpu/nn/functional/
norm.py``): ``batch_norm``, ``sync_batch_norm``, ``layer_norm`` and
``rms_norm``.

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

``sync_batch_norm`` (``SyncBatchNorm`` in training, over a group of more
than one rank) normalizes by the statistics of the whole group's batch,
as upstream Paddle does and as the reference's data-parallel compiled
step computes them over the mesh. It is written over
``torch.distributed`` rather than ``torch.nn.SyncBatchNorm``, which
refuses CPU tensors, so one code runs under gloo on the CPU and on the
card:

- forward: one all-reduce of [Σx, Σx², count] per channel in fp32; mean
  = Σx / N, var = Σx² / N − mean² (biased, for the normalization), and
  the running statistics move as ``batch_norm``'s do, with the unbiased
  var · N / (N − 1);
- backward: one all-reduce of [Σdy, Σdy·x̂]; dx = w·invstd·(dy − Σdy/N −
  x̂·Σdy·x̂/N) with the group's sums, while dw and db are this rank's own
  Σdy·x̂ and Σdy: the data-parallel gradient sync averages them like any
  other parameter's gradient.

The output takes ``x``'s dtype; the arithmetic is fp32.
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


def _channel_dims(x):
    return [d for d in range(x.ndim) if d != 1]


def _per_channel(v, x):
    return v.reshape([1, -1] + [1] * (x.ndim - 2))


def _group_sum(buf, group):
    """Sum ``buf`` over ``group`` in place."""
    import torch.distributed as dist
    dist.all_reduce(buf, group=group.pg)
    return buf


class _SyncBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, group):
        dims = _channel_dims(x)
        xf = x.to(torch.float32)
        c = x.shape[1]
        count = torch.tensor([x.numel() // c], dtype=torch.float32,
                             device=x.device)
        buf = _group_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                    count]), group)
        n = buf[-1]
        mean = buf[:c] / n
        var = torch.clamp(buf[c:2 * c] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        w = torch.ones_like(mean) if weight is None else \
            weight.to(torch.float32)
        b = torch.zeros_like(mean) if bias is None else \
            bias.to(torch.float32)
        y = (xf - _per_channel(mean, x)) * _per_channel(invstd * w, x) \
            + _per_channel(b, x)
        with torch.no_grad():
            running_mean.mul_(momentum).add_(
                (1.0 - momentum) * mean.to(running_mean.dtype))
            running_var.mul_(momentum).add_(
                (1.0 - momentum) * (var * n / (n - 1)).to(running_var.dtype))
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.has_bias = bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dims = _channel_dims(x)
        c = x.shape[1]
        dyf = dy.to(torch.float32)
        xhat = (x.to(torch.float32) - _per_channel(mean, x)) \
            * _per_channel(invstd, x)
        sdy = dyf.sum(dims)
        sdyx = (dyf * xhat).sum(dims)
        buf = _group_sum(torch.cat([sdy, sdyx]), ctx.group)
        w = torch.ones_like(mean) if weight is None else \
            weight.to(torch.float32)
        dx = _per_channel(w * invstd, x) * (
            dyf - _per_channel(buf[:c] / n, x)
            - xhat * _per_channel(buf[c:] / n, x))
        dw = None if weight is None else sdyx.to(weight.dtype)
        db = sdy.to(ctx.bias_dtype) if ctx.has_bias else None
        return dx.to(x.dtype), dw, db, None, None, None, None, None


def sync_batch_norm(x, running_mean, running_var, weight=None, bias=None,
                    momentum=0.9, epsilon=1e-5, data_format="NCHW",
                    group=None):
    """Training-mode batch norm over the whole ``group``'s batch (the
    default group: the world); see the module docstring."""
    from ...distributed.collective import _get_group
    x, moved = channels_first(x, data_format)
    y = _SyncBatchNorm.apply(x, weight, bias, running_mean, running_var,
                             float(momentum), float(epsilon),
                             _get_group(group))
    return restore_layout(y, moved)
