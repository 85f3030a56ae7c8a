"""Megatron-style sequence parallelism (counterpart: ``paddle_tpu/
distributed/fleet/utils/sequence_parallel_utils.py``; upstream
``fleet/utils/sequence_parallel_utils.py``). Layout [b, s, h]; the
sequence dimension (1) is split over the mesh's mp group.

- ``ScatterOp``: forward this rank's chunk of the sequence, backward an
  all-gather; ``GatherOp``: forward all-gather, backward the chunk;
  ``AllGatherOp``: forward all-gather, backward reduce-scatter (sum);
  ``ReduceScatterOp``: forward reduce-scatter (sum), backward all-gather.
- ``ColumnSequenceParallelLinear``: all-gather of the sequence, then the
  column matmul on the local [in, out/mp] weight.
- ``RowSequenceParallelLinear``: the row matmul on the local [in/mp, out]
  weight, a reduce-scatter onto the sequence, then the bias on the local
  rows (the bias is marked sequence-parallel).
- ``register_sequence_parallel_allreduce_hooks``: the reference's is a
  no-op (GSPMD reduces the LayerNorm gradients); here it is real: a
  gradient hook on each parameter marked with
  ``mark_as_sequence_parallel_parameter`` all-reduces (sums) its gradient
  over mp, since each rank saw only its rows of the sequence. The hook
  fires under ``backward()`` and under ``torch.autograd.grad``
  (``CompiledTrainStep``).
"""
from __future__ import annotations

import numpy as np
import torch

from ....nn import functional as F
from ....nn.layer.common import _xavier_uniform
from ....nn.layer.layers import Layer
from ...sharding_api import Placement, split_placement
from ..meta_parallel.mp_layers import (_AllGather, _Gather, _ReduceScatter,
                                       _Split, _all_reduce, _apply, _make,
                                       _mp)

_SEQ = 1


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True


def zigzag_indices(seq_len, n):
    """Gather index [seq_len] mapping natural order -> zigzag shard order:
    x_zigzag = x[idx]; shard i of n then holds chunks (i, 2n-1-i) of 2n.
    Requires seq_len % (2*n) == 0."""
    if seq_len % (2 * n):
        raise ValueError(
            f"zigzag layout needs seq_len ({seq_len}) divisible by 2*sep "
            f"({2 * n})")
    half = seq_len // (2 * n)
    idx = np.empty(seq_len, np.int32)
    for i in range(n):
        base = 2 * i * half
        idx[base:base + half] = np.arange(i * half, (i + 1) * half)
        idx[base + half:base + 2 * half] = np.arange(
            (2 * n - 1 - i) * half, (2 * n - i) * half)
    return idx


def zigzag_inverse_indices(seq_len, n):
    """Inverse of zigzag_indices: x = x_zigzag[inverse_idx]."""
    idx = zigzag_indices(seq_len, n)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(seq_len, dtype=np.int32)
    return inv


def register_sequence_parallel_allreduce_hooks(
        model, fuse_sequence_parallel_allreduce=False):
    """A gradient hook on every parameter of ``model`` marked
    sequence-parallel: its gradient summed over mp. Registered once per
    parameter."""
    group = _mp()[0]
    if group.nranks == 1:
        return []
    handles = []
    for p in model.parameters():
        if getattr(p, "sequence_parallel", False) and \
                not getattr(p, "_sp_hooked", False):
            p._sp_hooked = True
            handles.append(p.register_hook(
                lambda g, group=group: _all_reduce(g, group)))
    return handles


class ScatterOp:
    @staticmethod
    def apply(x, group=None):
        return _apply(_Split, x, group or _mp()[0], _SEQ)


class GatherOp:
    @staticmethod
    def apply(x, group=None):
        return _apply(_Gather, x, group or _mp()[0], _SEQ)


class AllGatherOp:
    @staticmethod
    def apply(x, group=None):
        return _apply(_AllGather, x, group or _mp()[0], _SEQ)


class ReduceScatterOp:
    @staticmethod
    def apply(x, group=None):
        return _apply(_ReduceScatter, x, group or _mp()[0], _SEQ)


class ColumnSequenceParallelLinear(Layer):
    """Input [b, s/mp, in] (sequence-split), output [b, s, out/mp]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None,
                 generator=None, packed=1):
        super().__init__()
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear keeps its "
                             "output split (gather_output=False)")
        group, mp, r = _mp()
        self._group = mp_group or group
        self.packed = packed
        full = _xavier_uniform((in_features, out_features), generator)
        self.weight = _make(full, split_placement(full.shape, 1, mp, r,
                                                  packed), device, dtype)
        self.weight.is_distributed = True
        if has_bias:
            self.bias = _make(torch.zeros(out_features), split_placement(
                (out_features,), 0, mp, r, packed), device, dtype)
            self.bias.is_distributed = True
        else:
            self.bias = None

    def forward(self, x):
        return F.linear(AllGatherOp.apply(x, self._group), self.weight,
                        self.bias)


class RowSequenceParallelLinear(Layer):
    """Input [b, s, in/mp], output [b, s/mp, out] (sequence-split)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        group, mp, r = _mp()
        self._group = mp_group or group
        full = _xavier_uniform((in_features, out_features), generator)
        self.weight = _make(full, split_placement(full.shape, 0, mp, r),
                            device, dtype)
        self.weight.is_distributed = True
        if has_bias:
            self.bias = _make(torch.zeros(out_features),
                              Placement.whole((out_features,)), device,
                              dtype)
            mark_as_sequence_parallel_parameter(self.bias)
        else:
            self.bias = None

    def forward(self, x):
        y = ReduceScatterOp.apply(F.linear(x, self.weight, None),
                                  self._group)
        if self.bias is not None:
            y = y + self.bias
        return y
