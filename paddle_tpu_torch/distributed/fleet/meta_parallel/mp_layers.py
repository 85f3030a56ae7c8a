"""Tensor-parallel layers (counterpart: ``paddle_tpu/distributed/fleet/
meta_parallel/mp_layers.py``; upstream ``parallel_layers/mp_layers.py``).

The reference's layers own the full logical weight with a mesh sharding
and GSPMD puts the Megatron collectives in. The port has no GSPMD: each
rank holds its own piece and issues the collectives, as upstream Paddle
does, over the mesh's mp group (``sharding_api.get_default_mesh()``):

- ``ColumnParallelLinear``: the local [in, out/mp] weight and [out/mp]
  bias; the input passes an identity whose backward all-reduces its
  gradient over mp; ``gather_output=True`` all-gathers the columns.
- ``RowParallelLinear``: the local [in/mp, out] weight; the output is
  all-reduced over mp and then the unsharded bias is added, as the
  reference adds it after its psum. ``input_is_parallel=False`` takes the
  rank's columns of a whole input.
- ``VocabParallelEmbedding``: the local [V/mp, h] rows; ids outside the
  rank's range give zeros, then an mp all-reduce.
- ``ParallelCrossEntropy``: softmax cross-entropy over vocab-sharded
  logits (the max, the sum of exponentials and the target's logit each
  all-reduced over mp), ``ignore_index`` kept, the reference's
  ``F.cross_entropy(reduction="none")`` of the whole logits.

Each parameter carries its ``Placement`` (its global shape and the
slices it holds, ``sharding_api``) for the checkpoint and ``convert.py``,
and ``is_distributed = True`` where it is split, as the reference sets
it. A layer's weights are drawn whole on the CPU from ``generator`` (the
reference's Xavier-uniform, zero biases) and the rank keeps its piece, so
one seed gives the same global weights at every mp degree. ``packed``
(an extension for a fused projection such as GPT's qkv): the output is
``packed`` equal blocks and each rank holds its share of every block, so
rank r keeps heads [r*nh/mp, (r+1)*nh/mp) of each of q, k and v.
``comm_meter`` counts the mp collectives' calls, bytes and time when it
is switched on (``chip_smoke.py``'s comm ms a step).
"""
from __future__ import annotations

import time

import torch

from .... import resolve_device
from ....nn import functional as F
from ....nn.layer.common import _xavier_uniform
from ....nn.layer.layers import Layer
from ...sharding_api import Placement, get_default_mesh, place, \
    split_placement


def _mp():
    """(mp group, mp degree, this rank's mp index) of the default mesh."""
    mesh = get_default_mesh()
    g = mesh.group("mp")
    return g, g.nranks, mesh.coord["mp"]


# the mp collectives' meter (off by default): calls, bytes in, and the
# host time of each, the card synchronized before and after it so the
# compute queued ahead is not counted
_METER = {"on": False, "calls": 0, "bytes": 0, "ns": 0}


def comm_meter(on=None, reset=False):
    """A snapshot of the mp collectives' meter; ``on`` switches it,
    ``reset`` zeroes it."""
    if reset:
        _METER.update(calls=0, bytes=0, ns=0)
    if on is not None:
        _METER["on"] = bool(on)
    return {"calls": _METER["calls"], "bytes": _METER["bytes"],
            "ms": _METER["ns"] / 1e6}


def _metered(x, run):
    if not _METER["on"]:
        return run()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter_ns()
    out = run()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    _METER["ns"] += time.perf_counter_ns() - t0
    _METER["calls"] += 1
    _METER["bytes"] += x.numel() * x.element_size()
    return out


def _all_reduce(x, group):
    from ...collective import all_reduce
    t = x.contiguous().clone()
    _metered(t, lambda: all_reduce(t, group=group))
    return t


def _all_gather(x, group, dim):
    from ...collective import all_gather
    rows = []
    x = x.contiguous()
    _metered(x, lambda: all_gather(rows, x, group=group))
    return torch.cat(rows, dim=dim)


def _chunk(x, group, dim):
    return x.chunk(group.nranks, dim=dim)[group.rank].contiguous()


def _reduce_scatter(x, group, dim):
    from ...collective import reduce_scatter
    parts = [c.contiguous() for c in x.chunk(group.nranks, dim=dim)]
    out = torch.empty_like(parts[group.rank])
    _metered(x, lambda: reduce_scatter(out, parts, group=group))
    return out


class _CIdentity(torch.autograd.Function):
    """Forward: the input; backward: the gradient all-reduced over the
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    """Forward: the sum over the group; backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    """Forward: this rank's chunk along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Forward: all-gather along ``dim``; backward: this rank's chunk."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    """Forward: all-gather along ``dim``; backward: reduce-scatter (sum)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """Forward: reduce-scatter (sum) along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def _apply(fn, x, group, *args):
    """``fn`` over ``group``; an identity on a group of one rank."""
    if group.nranks == 1:
        return x
    return fn.apply(x, group, *args)


def c_identity(x, group=None):
    return _apply(_CIdentity, x, group or _mp()[0])


def mp_allreduce(x, group=None):
    return _apply(_AllReduce, x, group or _mp()[0])


def c_split(x, group=None, dim=-1):
    return _apply(_Split, x, group or _mp()[0], dim)


def c_concat(x, group=None, dim=-1):
    return _apply(_Gather, x, group or _mp()[0], dim)


def _make(values, placement, device, dtype):
    p = torch.nn.Parameter(placement.take(values).to(
        device=resolve_device(device), dtype=dtype or torch.float32))
    return place(p, placement)


class ColumnParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None,
                 generator=None, packed=1):
        super().__init__()
        group, mp, r = _mp()
        self._group = mp_group or group
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.packed = packed
        full = _xavier_uniform((in_features, out_features), generator)
        self.weight = _make(full, split_placement(
            full.shape, 1, mp, r, packed), device, dtype)
        self.weight.is_distributed = True
        if has_bias:
            self.bias = _make(torch.zeros(out_features), split_placement(
                (out_features,), 0, mp, r, packed), device, dtype)
            self.bias.is_distributed = True
        else:
            self.bias = None

    def forward(self, x):
        y = F.linear(c_identity(x, self._group), self.weight, self.bias)
        if not self.gather_output or self._group.nranks == 1:
            return y
        y = c_concat(y, self._group)
        if self.packed > 1:
            # rank-major [r][block][w] -> block-major [block][r][w]
            lead = y.shape[:-1]
            w = self.out_features // self.packed // self._group.nranks
            y = y.reshape(*lead, self._group.nranks, self.packed, w) \
                .transpose(-2, -3).reshape(*lead, self.out_features)
        return y


class RowParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        group, mp, r = _mp()
        self._group = mp_group or group
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        full = _xavier_uniform((in_features, out_features), generator)
        self.weight = _make(full, split_placement(full.shape, 0, mp, r),
                            device, dtype)
        self.weight.is_distributed = True
        self.bias = _make(torch.zeros(out_features),
                          Placement.whole((out_features,)), device, dtype) \
            if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = c_split(x, self._group)
        y = mp_allreduce(F.linear(x, self.weight, None), self._group)
        if self.bias is not None:
            y = y + self.bias
        return y


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None,
                 generator=None, init_std=None):
        super().__init__()
        group, mp, r = _mp()
        self._group = mp_group or group
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        shape = (num_embeddings, embedding_dim)
        if init_std is None:
            full = _xavier_uniform(shape, generator)
        else:
            full = torch.empty(shape).normal_(0.0, init_std,
                                              generator=generator)
        placement = split_placement(shape, 0, mp, r)
        self.vocab_start = placement.pieces[0][1][0][0]
        self.vocab_end = placement.pieces[0][1][0][1]
        self.weight = _make(full, placement, device, dtype)
        self.weight.is_distributed = True

    def forward(self, x):
        if self._group.nranks == 1:
            return F.embedding(x, self.weight)
        outside = (x < self.vocab_start) | (x >= self.vocab_end)
        local = (x - self.vocab_start).masked_fill(outside, 0)
        out = F.embedding(local, self.weight)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return mp_allreduce(out, self._group)


class _VocabParallelCE(torch.autograd.Function):
    """Per-row softmax cross-entropy of vocab-sharded logits [..., V/mp]
    (fp32 inside), 0 where the label is ``ignore_index``."""

    @staticmethod
    def forward(ctx, logits, label, group, vocab_start, ignore_index):
        x = logits.float()
        m = x.max(dim=-1, keepdim=True).values
        if group.nranks > 1:
            from ...collective import ReduceOp, all_reduce
            all_reduce(m, op=ReduceOp.MAX, group=group)
        e = torch.exp(x - m)
        s = e.sum(dim=-1, keepdim=True)
        v = x.shape[-1]
        local = label - vocab_start
        mine = (local >= 0) & (local < v)
        idx = local.clamp(0, v - 1).unsqueeze(-1)
        picked = torch.where(mine, (x - m).gather(-1, idx).squeeze(-1),
                             torch.zeros((), device=x.device))
        if group.nranks > 1:
            s = _all_reduce(s, group)
            picked = _all_reduce(picked, group)
        loss = torch.log(s.squeeze(-1)) - picked
        valid = label != ignore_index
        loss = torch.where(valid, loss, torch.zeros((), device=x.device))
        ctx.save_for_backward(e, s, idx, mine, valid)
        ctx.in_dtype = logits.dtype
        return loss.to(logits.dtype)

    @staticmethod
    def backward(ctx, g):
        e, s, idx, mine, valid = ctx.saved_tensors
        grad = e / s
        onehot = torch.zeros_like(grad).scatter_(
            -1, idx, mine.unsqueeze(-1).to(grad.dtype))
        scale = (g.float() * valid.to(torch.float32)).unsqueeze(-1)
        return ((grad - onehot) * scale).to(ctx.in_dtype), None, None, \
            None, None


class ParallelCrossEntropy(Layer):
    """``forward(logits, label)``: the per-row loss (the label's shape) of
    logits sharded over the vocabulary as ``VocabParallelEmbedding``
    shards it."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._group = mp_group

    def forward(self, input, label):
        group, mp, r = _mp()
        group = self._group or group
        if label.ndim == input.ndim and label.shape[-1] == 1:
            label = label.squeeze(-1)
        v = input.shape[-1]
        return _VocabParallelCE.apply(input, label, group, r * v,
                                      self.ignore_index)
