"""Shape, layout, gather/scatter, search and sort ops (counterpart:
``paddle_tpu/ops/manipulation.py``).

Paddle's own meanings hold: ``reshape`` with 0 copies that dimension
(and -1 infers one), ``transpose`` takes a permutation, ``split`` takes
a count or section sizes (one may be -1), ``gather``/``index_select``
take an axis, ``argmax``/``argsort``/``topk`` indices are int64. The
in-place forms (``reshape_``, ``squeeze_``, ``scatter_``, ...) replace
the payload, as the reference does.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..tensor import Tensor
from .common import (binary_args, ensure_tensor, int_list, promote, raw,
                     scalar_of, single_axis, tensor_list)
from .dispatch import dispatch, nondiff

_py_slice = slice   # the API name `slice` below shadows the builtin


def _ax(x):
    return raw(x).ndim


def _inplace(x, out):
    x._replace(raw(out))
    return x


def _reshape_impl(x, shape):
    return x.reshape(shape)


def reshape(x, shape, name=None):
    x = ensure_tensor(x)
    src = raw(x).shape
    shp = tuple(src[i] if s == 0 and i < len(src) else s
                for i, s in enumerate(int_list(shape)))
    return dispatch("reshape", _reshape_impl, x, shape=shp)


def reshape_(x, shape, name=None):
    return _inplace(x, reshape(x, shape))


def _transpose_impl(x, perm):
    return x.permute(perm)


def transpose(x, perm=None, name=None):
    x = ensure_tensor(x)
    if perm is None:
        perm = tuple(reversed(range(_ax(x))))
    return dispatch("transpose", _transpose_impl, x,
                    perm=tuple(int(p) for p in perm))


def t(x, name=None):
    x = ensure_tensor(x)
    return x if _ax(x) < 2 else transpose(x, [1, 0])


def _moveaxis_impl(v, source, destination):
    return torch.movedim(v, source, destination)


def moveaxis(x, source, destination, name=None):
    return dispatch("moveaxis", _moveaxis_impl, ensure_tensor(x),
                    source=tuple(np.atleast_1d(source).tolist()),
                    destination=tuple(np.atleast_1d(destination).tolist()))


def _concat_impl(*xs, axis):
    return torch.cat(xs, axis)


def concat(x, axis=0, name=None):
    xs = promote(*tensor_list(x))
    return dispatch("concat", _concat_impl, *xs,
                    axis=int(scalar_of(axis)))


def _stack_impl(*xs, axis):
    return torch.stack(xs, axis)


def stack(x, axis=0, name=None):
    return dispatch("stack", _stack_impl, *tensor_list(x), axis=int(axis))


def _split_impl(x, sections, axis):
    return tuple(torch.split(x, sections, axis))


def _sections(dim, num_or_sections):
    if isinstance(num_or_sections, int):
        n = num_or_sections
        if dim % n:
            raise ValueError(f"dim {dim} not divisible by {n}")
        return [dim // n] * n
    secs = [int(scalar_of(s)) for s in num_or_sections]
    if -1 in secs:
        known = sum(s for s in secs if s != -1)
        secs = [dim - known if s == -1 else s for s in secs]
    return secs


def split(x, num_or_sections, axis=0, name=None):
    x = ensure_tensor(x)
    axis = single_axis(scalar_of(axis), _ax(x))
    secs = _sections(raw(x).shape[axis], num_or_sections)
    return list(dispatch("split", _split_impl, x, sections=secs, axis=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    x = ensure_tensor(x)
    axis = single_axis(axis, _ax(x))
    return [squeeze(o, axis) for o in split(x, raw(x).shape[axis], axis)]


unstack = unbind


def _squeeze_impl(x, axis):
    return x.squeeze(axis) if axis else x


def squeeze(x, axis=None, name=None):
    x = ensure_tensor(x)
    shp = raw(x).shape
    if axis is None:
        ax = tuple(i for i, s in enumerate(shp) if s == 1)
    else:
        axs = int_list(axis) if not isinstance(axis, int) else [axis]
        ax = tuple(single_axis(a, len(shp)) for a in axs
                   if shp[single_axis(a, len(shp))] == 1)
    return dispatch("squeeze", _squeeze_impl, x, axis=ax)


def squeeze_(x, axis=None, name=None):
    return _inplace(x, squeeze(x, axis))


def _unsqueeze_impl(x, axis):
    nd = x.ndim + len(axis)
    for a in sorted(a % nd for a in axis):
        x = x.unsqueeze(a)
    return x


def unsqueeze(x, axis, name=None):
    x = ensure_tensor(x)
    return dispatch("unsqueeze", _unsqueeze_impl, x,
                    axis=tuple(int_list(axis)))


def unsqueeze_(x, axis, name=None):
    return _inplace(x, unsqueeze(x, axis))


def _flatten_impl(x, start, stop):
    return x.flatten(start, stop)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = ensure_tensor(x)
    if _ax(x) == 0:
        return reshape(x, [1])
    return dispatch("flatten", _flatten_impl, x,
                    start=single_axis(start_axis, _ax(x)),
                    stop=single_axis(stop_axis, _ax(x)))


def _expand_impl(x, shape):
    return x.expand(shape)


def expand(x, shape, name=None):
    return dispatch("expand", _expand_impl, ensure_tensor(x),
                    shape=tuple(int_list(shape)))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return expand(x, list(raw(y).shape))


def broadcast_tensors(inputs, name=None):
    ts = tensor_list(inputs)
    tgt = torch.broadcast_shapes(*[raw(t).shape for t in ts])
    return [expand(t, list(tgt)) for t in ts]


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def _tile_impl(x, repeat_times):
    return x.tile(repeat_times)


def tile(x, repeat_times, name=None):
    return dispatch("tile", _tile_impl, ensure_tensor(x),
                    repeat_times=tuple(int_list(repeat_times)))


def _repeat_interleave_impl(x, repeats, axis):
    if isinstance(repeats, tuple):
        repeats = torch.tensor(repeats, device=x.device)
    return torch.repeat_interleave(x, repeats, axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = ensure_tensor(x)
    if axis is None:
        x, axis = flatten(x), 0
    reps = tuple(int_list(repeats)) if not isinstance(repeats, int) \
        else int(repeats)
    return dispatch("repeat_interleave", _repeat_interleave_impl, x,
                    repeats=reps, axis=single_axis(axis, _ax(x)))


def _flip_impl(x, axis):
    return torch.flip(x, axis)


def flip(x, axis, name=None):
    x = ensure_tensor(x)
    axs = [axis] if isinstance(axis, int) else int_list(axis)
    return dispatch("flip", _flip_impl, x,
                    axis=tuple(single_axis(a, _ax(x)) for a in axs))


def _roll_impl(x, shifts, axis):
    if axis is None:
        return torch.roll(x.reshape(-1), shifts).reshape(x.shape)
    return torch.roll(x, shifts, axis)


def roll(x, shifts, axis=None, name=None):
    sh = tuple(shifts) if isinstance(shifts, (list, tuple)) else int(shifts)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (
        None if axis is None else int(axis))
    return dispatch("roll", _roll_impl, ensure_tensor(x), shifts=sh, axis=ax)


def _rot90_impl(x, k, axes):
    return torch.rot90(x, k, axes)


def rot90(x, k=1, axes=(0, 1), name=None):
    return dispatch("rot90", _rot90_impl, ensure_tensor(x), k=int(k),
                    axes=tuple(axes))


def _cast_impl(x, dtype):
    return x.to(dtype)


def cast(x, dtype, name=None):
    x = ensure_tensor(x)
    td = dtype if isinstance(dtype, torch.dtype) \
        else dtype_mod.to_torch_dtype(dtype)
    if raw(x).dtype == td:
        return x
    return dispatch("cast", _cast_impl, x, dtype=td)


def _gather_impl(x, index, axis):
    return torch.index_select(x, axis, index.reshape(-1).long()) \
        .reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


def gather(x, index, axis=0, name=None):
    x, index = ensure_tensor(x), ensure_tensor(index)
    if raw(index).ndim == 2 and raw(index).shape[1] == 1:
        index = squeeze(index, 1)
    return dispatch("gather", _gather_impl, x, index,
                    axis=single_axis(scalar_of(axis), _ax(x)))


def _gather_nd_impl(x, index):
    return x[tuple(index.long().movedim(-1, 0))]


def gather_nd(x, index, name=None):
    return dispatch("gather_nd", _gather_nd_impl, ensure_tensor(x),
                    ensure_tensor(index))


def _take_along_axis_impl(x, indices, axis):
    shape = list(torch.broadcast_shapes(
        x.shape[:axis] + (1,) + x.shape[axis + 1:],
        indices.shape[:axis] + (1,) + indices.shape[axis + 1:]))
    shape[axis] = indices.shape[axis]
    xs = list(shape)
    xs[axis] = x.shape[axis]
    return torch.gather(x.expand(xs), axis, indices.long().expand(shape))


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr, indices = ensure_tensor(arr), ensure_tensor(indices)
    return dispatch("take_along_axis", _take_along_axis_impl, arr, indices,
                    axis=single_axis(axis, _ax(arr)))


def _put_along_axis_impl(x, indices, values, axis, reduce):
    idx = indices.long()
    vals = values.to(x.dtype).expand(idx.shape)
    if reduce == "assign":
        return x.scatter(axis, idx, vals)
    if reduce == "add":
        return x.scatter_add(axis, idx, vals)
    if reduce in ("multiply", "mul"):
        return x.scatter_reduce(axis, idx, vals, "prod")
    raise ValueError(f"unsupported reduce {reduce}")


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None,
                   include_self=True, broadcast=True):
    arr = ensure_tensor(arr)
    return dispatch("put_along_axis", _put_along_axis_impl, arr,
                    ensure_tensor(indices), ensure_tensor(values, ref=arr),
                    axis=single_axis(axis, _ax(arr)), reduce=reduce)


def put_along_axis_(arr, indices, values, axis, reduce="assign", name=None):
    return _inplace(arr, put_along_axis(arr, indices, values, axis, reduce))


def _scatter_impl(x, index, updates, overwrite):
    if index.ndim == 2:
        index = index[:, 0]
    index = index.long()
    if overwrite:
        return x.index_put((index,), updates.to(x.dtype))
    zeroed = x.index_put((index,), torch.zeros_like(updates, dtype=x.dtype))
    return zeroed.index_put((index,), updates.to(x.dtype), accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    return dispatch("scatter", _scatter_impl, ensure_tensor(x),
                    ensure_tensor(index), ensure_tensor(updates),
                    overwrite=bool(overwrite))


def scatter_(x, index, updates, overwrite=True, name=None):
    return _inplace(x, scatter(x, index, updates, overwrite))


def _scatter_nd_add_impl(x, index, updates):
    return x.index_put(tuple(index.long().movedim(-1, 0)),
                       updates.to(x.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return dispatch("scatter_nd_add", _scatter_nd_add_impl, ensure_tensor(x),
                    ensure_tensor(index), ensure_tensor(updates))


def scatter_nd(index, updates, shape, name=None):
    updates = ensure_tensor(updates)
    u = raw(updates)
    z = Tensor._wrap(torch.zeros(tuple(int_list(shape)), dtype=u.dtype,
                                 device=u.device))
    return scatter_nd_add(z, index, updates)


def _index_select_impl(x, index, axis):
    return torch.index_select(x, axis, index.long())


def index_select(x, index, axis=0, name=None):
    x = ensure_tensor(x)
    return dispatch("index_select", _index_select_impl, x,
                    ensure_tensor(index), axis=single_axis(axis, _ax(x)))


def _index_sample_impl(x, index):
    return torch.gather(x, 1, index.long())


def index_sample(x, index, name=None):
    return dispatch("index_sample", _index_sample_impl, ensure_tensor(x),
                    ensure_tensor(index))


def _index_add_impl(x, index, value, axis):
    return x.index_add(axis, index.long(), value.to(x.dtype))


def index_add(x, index, axis, value, name=None):
    x = ensure_tensor(x)
    return dispatch("index_add", _index_add_impl, x, ensure_tensor(index),
                    ensure_tensor(value, ref=x),
                    axis=single_axis(axis, _ax(x)))


def _index_put_impl(x, value, *indices, accumulate):
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in indices)
    return x.index_put(idx, value.to(x.dtype), accumulate=accumulate)


def index_put(x, indices, value, accumulate=False, name=None):
    x = ensure_tensor(x)
    return dispatch("index_put", _index_put_impl, x,
                    ensure_tensor(value, ref=x),
                    *[ensure_tensor(i) for i in indices],
                    accumulate=bool(accumulate))


def index_put_(x, indices, value, accumulate=False, name=None):
    return _inplace(x, index_put(x, indices, value, accumulate))


def _masked_select_impl(x, mask):
    return torch.masked_select(x, mask.bool())


def masked_select(x, mask, name=None):
    return dispatch("masked_select", _masked_select_impl, ensure_tensor(x),
                    ensure_tensor(mask))


def _masked_fill_impl(x, mask, value):
    return torch.where(mask.bool(), value.to(x.dtype), x)


def masked_fill(x, mask, value, name=None):
    x = ensure_tensor(x)
    return dispatch("masked_fill", _masked_fill_impl, x, ensure_tensor(mask),
                    ensure_tensor(value, ref=x))


def _where_impl(cond, x, y):
    return torch.where(cond.bool(), x, y)


def where(condition, x=None, y=None, name=None):
    condition = ensure_tensor(condition)
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x, y = binary_args(x, y)
    return dispatch("where", _where_impl, condition, x, y)


def _nonzero_impl(x):
    return torch.nonzero(x)


def nonzero(x, as_tuple=False):
    out = nondiff("nonzero", _nonzero_impl, ensure_tensor(x))
    if as_tuple:
        return tuple(out[:, i:i + 1] if isinstance(out, torch.Tensor)
                     else Tensor._wrap(raw(out)[:, i:i + 1])
                     for i in range(raw(out).shape[1]))
    return out


def _pad_impl(x, pad, mode, value):
    flat = [p for pair in reversed(pad) for p in pair]
    if mode == "constant":
        return torch.nn.functional.pad(x, flat, value=value)
    n = len(pad)
    while n and pad[len(pad) - n] == (0, 0):
        n -= 1
    flat = [p for pair in reversed(pad[len(pad) - n:]) for p in pair]
    # torch pads the trailing dims of a batched input in these modes
    lead = x.shape[:x.ndim - n]
    y = x.reshape((1, -1) + x.shape[x.ndim - n:])
    y = torch.nn.functional.pad(y, flat, mode=mode)
    return y.reshape(lead + y.shape[2:])


def pad(x, pad, mode="constant", value=0.0, data_format=None, name=None,
        pad_from_left_axis=True):
    """``pad`` is per-axis [lo, hi] pairs from the LAST axis backwards when
    it covers fewer than all axes (upstream's convention), per axis from
    the first when it covers all; with ``data_format`` it covers the
    spatial axes."""
    x = ensure_tensor(x)
    pad = int_list(pad)
    nd = _ax(x)
    pairs_in = [tuple(pad[i:i + 2]) for i in range(0, len(pad), 2)]
    if data_format and len(pad) == 2 * (nd - 2):
        rev = list(reversed(pairs_in))
        pairs = ([(0, 0)] + rev + [(0, 0)]
                 if data_format in ("NHWC", "NLC", "NDHWC")
                 else [(0, 0), (0, 0)] + rev)
    elif len(pad) == 2 * nd:
        pairs = pairs_in
    else:
        pairs = [(0, 0)] * (nd - len(pairs_in)) + list(reversed(pairs_in))
    return dispatch("pad", _pad_impl, x, pad=tuple(pairs), mode=mode,
                    value=float(value))


# --------------------------------------------------------- search / sort ----
def _argmax_impl(x, axis, keepdim, dtype):
    if axis is None:
        out = torch.argmax(x.reshape(-1))
        return (out.reshape([1] * x.ndim) if keepdim else out).to(dtype)
    return torch.argmax(x, axis, keepdim=keepdim).to(dtype)


def _argmin_impl(x, axis, keepdim, dtype):
    if axis is None:
        out = torch.argmin(x.reshape(-1))
        return (out.reshape([1] * x.ndim) if keepdim else out).to(dtype)
    return torch.argmin(x, axis, keepdim=keepdim).to(dtype)


def _arg(name, impl, x, axis, keepdim, dtype):
    x = ensure_tensor(x)
    ax = None if axis is None else single_axis(scalar_of(axis), _ax(x))
    return nondiff(name, impl, x, axis=ax, keepdim=bool(keepdim),
                   dtype=dtype_mod.to_torch_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg("argmax", _argmax_impl, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg("argmin", _argmin_impl, x, axis, keepdim, dtype)


def _argsort_impl(x, axis, descending, stable):
    return torch.argsort(x, dim=axis, descending=descending, stable=stable)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    x = ensure_tensor(x)
    return nondiff("argsort", _argsort_impl, x,
                   axis=single_axis(axis, _ax(x)),
                   descending=bool(descending), stable=bool(stable))


def sort(x, axis=-1, descending=False, stable=False, name=None):
    x = ensure_tensor(x)
    idx = argsort(x, axis, descending, stable)
    return take_along_axis(x, idx, axis)


def _topk_idx_impl(x, k, axis, largest):
    return torch.topk(x, k, axis, largest=largest, sorted=True)[1]


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    x = ensure_tensor(x)
    ax = _ax(x) - 1 if axis is None else single_axis(axis, _ax(x))
    idx = nondiff("topk_idx", _topk_idx_impl, x, k=int(scalar_of(k)),
                  axis=ax, largest=bool(largest))
    return take_along_axis(x, idx, ax), idx


def _kthvalue_idx_impl(x, k, axis):
    return torch.kthvalue(x, k, axis, keepdim=True)[1]


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = single_axis(axis, _ax(x))
    idx = nondiff("kthvalue_idx", _kthvalue_idx_impl, x, k=int(k), axis=ax)
    vals = take_along_axis(x, idx, ax)
    if not keepdim:
        vals, idx = squeeze(vals, ax), squeeze(idx, ax)
    return vals, idx


def _mode_impl(x, axis):
    xm = x.movedim(axis, -1)
    srt = torch.sort(xm, -1).values
    counts = (srt[..., :, None] == srt[..., None, :]).sum(-1)
    pos = torch.argmax(counts, -1)      # the first maximum: the smallest
    values = torch.gather(srt, -1, pos[..., None])[..., 0]
    n = xm.shape[-1]
    ar = torch.arange(n, device=x.device).expand(xm.shape)
    idx = torch.where(xm == values[..., None], ar, torch.full_like(ar, -1))
    return values, idx.amax(-1)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest wins ties) and
    the index of its last occurrence."""
    x = ensure_tensor(x)
    ax = single_axis(axis, _ax(x))
    values, idx = dispatch("mode", _mode_impl, x, axis=ax)
    if keepdim:
        values, idx = unsqueeze(values, ax), unsqueeze(idx, ax)
    return values, idx


def _searchsorted_impl(seq, values, right):
    return torch.searchsorted(seq, values.to(seq.dtype), right=right)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq = ensure_tensor(sorted_sequence)
    out = nondiff("searchsorted", _searchsorted_impl, seq,
                  ensure_tensor(values, ref=seq), right=bool(right))
    return cast(out, "int32") if out_int32 else out


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    v = raw(x).detach()
    arr = v.cpu().numpy() if v.dtype != torch.bfloat16 else None
    res = np.unique(arr, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    res = res if isinstance(res, tuple) else (res,)
    outs = [Tensor._wrap(torch.from_numpy(np.ascontiguousarray(res[0]))
                         .to(v.device))]
    for extra in res[1:]:
        outs.append(Tensor._wrap(torch.from_numpy(
            extra.reshape(-1).astype(np.int64)).to(v.device)))
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    v = raw(x).detach()
    if axis is None:
        v = v.reshape(-1)
        ax = 0
    else:
        ax = axis % v.ndim
    vals, inv, cnt = torch.unique_consecutive(
        v, return_inverse=True, return_counts=True, dim=ax)
    outs = [Tensor._wrap(vals)]
    if return_inverse:
        outs.append(Tensor._wrap(inv.reshape(-1).long()))
    if return_counts:
        outs.append(Tensor._wrap(cnt.long()))
    return outs[0] if len(outs) == 1 else tuple(outs)


def _shard_index_impl(x, index_num, nshards, shard_id, ignore_value):
    size = index_num // nshards
    lo = shard_id * size
    within = (x >= lo) & (x < lo + size)
    return torch.where(within, x - lo, torch.full_like(x, ignore_value))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return nondiff("shard_index", _shard_index_impl, ensure_tensor(input),
                   index_num=int(index_num), nshards=int(nshards),
                   shard_id=int(shard_id), ignore_value=int(ignore_value))


def numel(x, name=None):
    v = raw(ensure_tensor(x))
    return Tensor._wrap(torch.tensor(v.numel(), dtype=torch.int64,
                                     device=v.device))


def shape(x):
    v = raw(ensure_tensor(x))
    return Tensor._wrap(torch.tensor(list(v.shape), dtype=torch.int32,
                                     device=v.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def rank(x):
    v = raw(ensure_tensor(x))
    return Tensor._wrap(torch.tensor(v.ndim, dtype=torch.int32,
                                     device=v.device))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, list(raw(other).shape))


def as_strided(x, shape, stride, offset=0, name=None):
    raise NotImplementedError(
        "as_strided is not part of the surface (as in the reference); use "
        "reshape or slice")


def _tensordot_impl(a, b, axes):
    return torch.tensordot(a, b, dims=axes)


def tensordot(x, y, axes=2, name=None):
    x, y = binary_args(x, y)
    ax = axes
    if isinstance(axes, (list, tuple)):
        ax = tuple(tuple(a) if isinstance(a, (list, tuple)) else a
                   for a in axes)
        if all(isinstance(a, int) for a in ax):
            ax = (ax, ax)
    return dispatch("tensordot", _tensordot_impl, x, y, axes=ax)


def _one_hot_impl(x, num_classes):
    return torch.nn.functional.one_hot(x.long(), num_classes) \
        .to(torch.float32)


def one_hot(x, num_classes, name=None):
    return nondiff("one_hot", _one_hot_impl, ensure_tensor(x),
                   num_classes=int(num_classes))


def _bincount_impl(x, w, minlength):
    return torch.bincount(x.long(), w, minlength)


def bincount(x, weights=None, minlength=0, name=None):
    x = ensure_tensor(x)
    w = None if weights is None else ensure_tensor(weights)
    return nondiff("bincount", _bincount_impl, x, w,
                   minlength=int(minlength))


def _range_of(x, min, max):
    if min == 0 and max == 0:
        v = raw(x)
        mn, mx = float(v.min()), float(v.max())
    else:
        mn, mx = float(min), float(max)
    if mn == mx:
        mn, mx = mn - 0.5, mx + 0.5
    return mn, mx


def _histogram_impl(x, bins, min, max):
    return torch.histc(x.to(torch.float32), bins, min, max)


def histogram(input, bins=100, min=0, max=0, name=None):
    input = ensure_tensor(input)
    mn, mx = _range_of(input, min, max)
    return nondiff("histogram", _histogram_impl, input, bins=int(bins),
                   min=mn, max=mx)


def _histogram_bin_edges_impl(x, bins, min, max):
    return torch.linspace(min, max, bins + 1, dtype=x.dtype, device=x.device)


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    input = ensure_tensor(input)
    mn, mx = _range_of(input, min, max)
    return nondiff("histogram_bin_edges", _histogram_bin_edges_impl, input,
                   bins=int(bins), min=mn, max=mx)


def clip_(x, min=None, max=None, name=None):
    from .math import clip
    return _inplace(x, clip(x, min, max))


# ----------------------------------------------------------- slicing tail --
def _norm_start_end(dim, start, end):
    start, end = int(start), int(end)
    if start < 0:
        start = max(dim + start, 0)
    if end < 0:
        end = dim + end
    return min(start, dim), min(end, dim)


def _slice_impl(x, slices):
    idx = []
    for a, (s, e, st) in enumerate(slices):
        if st > 0:
            idx.append(_py_slice(s, e, st))
        else:
            idx.append(_py_slice(None))
    out = x[tuple(idx)]
    for a, (s, e, st) in enumerate(slices):
        if st < 0:
            # torch has no negative steps: flip, then step forward
            stop = -1 if e is None else e
            sel = torch.arange(s, stop, st, device=x.device)
            out = out.index_select(a, sel)
    return out


def slice(x, axes, starts, ends, name=None):  # noqa: A001 - paddle name
    x = ensure_tensor(x)
    shp = raw(x).shape
    sl = [(0, d, 1) for d in shp]
    for a, s, e in zip(int_list(axes), int_list(starts), int_list(ends)):
        a = single_axis(a, len(shp))
        s2, e2 = _norm_start_end(shp[a], s, e)
        sl[a] = (s2, max(e2, s2), 1)
    return dispatch("slice", _slice_impl, x, slices=tuple(sl))


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = ensure_tensor(x)
    shp = raw(x).shape
    sl = [(0, d, 1) for d in shp]
    for a, s, e, st in zip(int_list(axes), int_list(starts), int_list(ends),
                           int_list(strides)):
        a = single_axis(a, len(shp))
        d = shp[a]
        if st > 0:
            s2, e2 = _norm_start_end(d, s, e)
            sl[a] = (s2, max(e2, s2), st)
        else:
            s = d + s if s < 0 else s
            s = min(max(s, 0), d - 1)
            if e < 0:
                e = d + e
                e = None if e < 0 else e
            sl[a] = (s, e, st)
    return dispatch("strided_slice", _slice_impl, x, slices=tuple(sl))


def _take_impl(x, index, mode):
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.long()
    if mode == "wrap":
        idx = ((idx % n) + n) % n
    else:   # "clip" and "raise" (bounds are clipped, as in the reference)
        idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
    return flat[idx]


def take(x, index, mode="raise", name=None):
    if mode not in ("raise", "wrap", "clip"):
        raise ValueError(f"unknown mode {mode!r}")
    return dispatch("take", _take_impl, ensure_tensor(x),
                    ensure_tensor(index), mode=mode)


def _unflatten_impl(x, axis, sizes):
    return x.reshape(x.shape[:axis] + tuple(sizes) + x.shape[axis + 1:])


def unflatten(x, axis, shape, name=None):
    x = ensure_tensor(x)
    axis = single_axis(axis, _ax(x))
    sizes = tuple(int_list(shape))
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes = tuple(raw(x).shape[axis] // known if s == -1 else s
                      for s in sizes)
    return dispatch("unflatten", _unflatten_impl, x, axis=axis, sizes=sizes)


def _unfold_impl(x, axis, size, step):
    return x.unfold(axis, size, step)


def unfold(x, axis, size, step, name=None):
    x = ensure_tensor(x)
    return dispatch("unfold", _unfold_impl, x,
                    axis=single_axis(axis, _ax(x)), size=int(size),
                    step=int(step))


def _masked_scatter_impl(x, mask, value):
    m = mask.bool().expand(x.shape)
    idx = torch.cumsum(m.reshape(-1).int(), 0) - 1
    v = value.reshape(-1).to(x.dtype)
    gathered = v[idx.clamp(0, v.shape[0] - 1)].reshape(x.shape)
    return torch.where(m, gathered, x)


def masked_scatter(x, mask, value, name=None):
    x, mask, value = ensure_tensor(x), ensure_tensor(mask), \
        ensure_tensor(value)
    n_true = int(raw(mask).bool().expand(raw(x).shape).sum())
    if raw(value).numel() < n_true:
        raise ValueError(
            f"masked_scatter: value has {raw(value).numel()} elements but "
            f"mask selects {n_true}")
    return dispatch("masked_scatter", _masked_scatter_impl, x, mask, value)


def masked_scatter_(x, mask, value, name=None):
    return _inplace(x, masked_scatter(x, mask, value))


def _index_fill_impl(x, index, axis, value):
    return x.index_fill(axis, index.long(), value)


def index_fill(x, index, axis, value, name=None):
    x = ensure_tensor(x)
    return dispatch("index_fill", _index_fill_impl, x, ensure_tensor(index),
                    axis=single_axis(axis, _ax(x)),
                    value=float(scalar_of(value)))


def index_fill_(x, index, axis, value, name=None):
    return _inplace(x, index_fill(x, index, axis, value))


def _diag_embed_impl(x, offset, dim1, dim2):
    return torch.diag_embed(x, offset, dim1, dim2)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return dispatch("diag_embed", _diag_embed_impl, ensure_tensor(input),
                    offset=int(offset), dim1=int(dim1), dim2=int(dim2))


def _tensor_split(x, num_or_indices, axis):
    """NumPy's tensor_split as h/v/dsplit take it: an int is an equal
    split (it must divide), a sequence holds split indices."""
    x = ensure_tensor(x)
    axis = single_axis(axis, _ax(x))
    if isinstance(num_or_indices, int):
        return split(x, num_or_indices, axis)
    cuts = [0] + int_list(num_or_indices) + [raw(x).shape[axis]]
    secs = [b - a for a, b in zip(cuts[:-1], cuts[1:])]
    return list(dispatch("split", _split_impl, x, sections=secs, axis=axis))


def hsplit(x, num_or_indices, name=None):
    x = ensure_tensor(x)
    return _tensor_split(x, num_or_indices, 0 if _ax(x) == 1 else 1)


def vsplit(x, num_or_indices, name=None):
    return _tensor_split(x, num_or_indices, 0)


def dsplit(x, num_or_indices, name=None):
    return _tensor_split(x, num_or_indices, 2)


def tolist(x):
    return ensure_tensor(x).tolist() if isinstance(x, Tensor) \
        else raw(x).tolist()


def _hstack_impl(*xs):
    return torch.hstack(xs)


def hstack(x, name=None):
    return dispatch("hstack", _hstack_impl, *promote(*tensor_list(x)))


def _vstack_impl(*xs):
    return torch.vstack(xs)


def vstack(x, name=None):
    return dispatch("vstack", _vstack_impl, *promote(*tensor_list(x)))


row_stack = vstack


def _dstack_impl(*xs):
    return torch.dstack(xs)


def dstack(x, name=None):
    return dispatch("dstack", _dstack_impl, *promote(*tensor_list(x)))


def _column_stack_impl(*xs):
    return torch.column_stack(xs)


def column_stack(x, name=None):
    return dispatch("column_stack", _column_stack_impl,
                    *promote(*tensor_list(x)))


def _block_diag_impl(*xs):
    return torch.block_diag(*[torch.atleast_2d(v) for v in xs])


def block_diag(inputs, name=None):
    return dispatch("block_diag", _block_diag_impl,
                    *promote(*tensor_list(inputs)))


def _atleast_impl(x, nd):
    return (torch.atleast_1d, torch.atleast_2d, torch.atleast_3d)[nd - 1](x)


def _atleast(nd, *inputs):
    outs = [dispatch(f"atleast_{nd}d", _atleast_impl, ensure_tensor(i),
                     nd=nd) for i in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast(1, *inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(2, *inputs)


def atleast_3d(*inputs, name=None):
    return _atleast(3, *inputs)


def _select_scatter_impl(x, values, axis, index):
    return torch.select_scatter(x, values.to(x.dtype), axis, index)


def select_scatter(x, values, axis, index, name=None):
    x = ensure_tensor(x)
    return dispatch("select_scatter", _select_scatter_impl, x,
                    ensure_tensor(values), axis=single_axis(axis, _ax(x)),
                    index=int(index))


def _slice_scatter_impl(x, value, axes, starts, ends, strides):
    out = x
    if len(axes) == 1:
        return torch.slice_scatter(x, value.to(x.dtype), axes[0], starts[0],
                                   ends[0], strides[0])
    idx = [_py_slice(None)] * x.ndim
    for a, s, e, st in zip(axes, starts, ends, strides):
        idx[a] = _py_slice(s, e, st)
    out = x.clone()
    out[tuple(idx)] = value.to(x.dtype)
    return out


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    return dispatch("slice_scatter", _slice_scatter_impl, ensure_tensor(x),
                    ensure_tensor(value), axes=tuple(int_list(axes)),
                    starts=tuple(int_list(starts)),
                    ends=tuple(int_list(ends)),
                    strides=tuple(int_list(strides)))


def _cartesian_prod_impl(*xs):
    grids = torch.meshgrid(*xs, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], -1)


def cartesian_prod(x, name=None):
    return dispatch("cartesian_prod", _cartesian_prod_impl,
                    *promote(*tensor_list(x)))


def _combinations_impl(x, r, with_replacement):
    n = x.shape[0]
    it = (itertools.combinations_with_replacement(range(n), r)
          if with_replacement else itertools.combinations(range(n), r))
    idx = list(it)
    if not idx:
        return x.new_zeros((0, r))
    return x[torch.tensor(idx, device=x.device)]


def combinations(x, r=2, with_replacement=False, name=None):
    return dispatch("combinations", _combinations_impl, ensure_tensor(x),
                    r=int(r), with_replacement=bool(with_replacement))


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """N-dimensional histogram: (hist, [edges per dimension]), computed
    on the host as the reference does (its output is data-dependent)."""
    x = ensure_tensor(x)
    v = raw(x).detach()
    w = None if weights is None else raw(ensure_tensor(weights)).cpu() \
        .numpy()
    rng = None
    if ranges is not None:
        flat = [float(r) for r in ranges]
        rng = [tuple(flat[i:i + 2]) for i in range(0, len(flat), 2)]
    hist, edges = np.histogramdd(v.cpu().numpy(), bins=bins, range=rng,
                                 density=bool(density), weights=w)

    def back(a, dt):
        return Tensor._wrap(torch.from_numpy(a).to(device=v.device,
                                                   dtype=dt))
    # counts are int64 unless weighted or a density, as in the reference
    counts = torch.int64 if w is None and not density else v.dtype
    return back(hist, counts), [back(e, v.dtype) for e in edges]


def _crop_impl(x, offsets, shape):
    return x[tuple(_py_slice(o, o + s) for o, s in zip(offsets, shape))]


def crop(x, shape=None, offsets=None, name=None):
    """A box of ``shape`` from ``offsets`` (-1 in shape keeps the rest of
    that dim; offsets default to 0)."""
    x = ensure_tensor(x)
    xs = list(raw(x).shape)
    shp = int_list(shape if shape is not None else xs)
    offs = int_list(offsets if offsets is not None else [0] * len(xs))
    shp = [xs[i] - offs[i] if shp[i] == -1 else shp[i]
           for i in range(len(xs))]
    return dispatch("crop", _crop_impl, x, offsets=tuple(offs),
                    shape=tuple(shp))


def _diagonal_scatter_impl(x, y, offset, axis1, axis2):
    return torch.diagonal_scatter(x, y.to(x.dtype), offset, axis1, axis2)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    x = ensure_tensor(x)
    return dispatch("diagonal_scatter", _diagonal_scatter_impl, x,
                    ensure_tensor(y), offset=int(offset),
                    axis1=single_axis(axis1, _ax(x)),
                    axis2=single_axis(axis2, _ax(x)))


def _msort_impl(x):
    return torch.sort(x, 0).values


def msort(x, name=None):
    return dispatch("msort", _msort_impl, ensure_tensor(x))

