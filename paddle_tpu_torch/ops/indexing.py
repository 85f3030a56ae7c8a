"""``Tensor.__getitem__`` and ``__setitem__`` (counterpart:
``paddle_tpu/ops/indexing.py``): ints, slices, None, Ellipsis, bool
masks and integer index tensors or lists, through torch's indexing.
``__setitem__`` follows the reference, which replaces the payload: the
write goes to a copy that takes the tensor's place, so it works on a leaf
that requires grad (torch refuses an in-place write there) and leaves
every graph that saved the old value intact; the written value's
gradient flows."""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import Tensor
from .common import ensure_tensor, raw
from .dispatch import dispatch


def _index(idx, device):
    """A torch index from a paddle one: tensors unwrapped, lists and
    arrays made tensors on ``device``."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    out = []
    for it in idx:
        if isinstance(it, Tensor):
            it = it._value
        elif isinstance(it, (list, np.ndarray)):
            it = torch.as_tensor(np.asarray(it), device=device)
        if isinstance(it, torch.Tensor):
            if it.device != device:
                it = it.to(device)
            if it.dtype not in (torch.bool, torch.int64):
                it = it.long()
        elif isinstance(it, np.integer):
            it = int(it)
        elif isinstance(it, np.bool_):
            it = bool(it)
        out.append(it)
    return tuple(out)


_AT = object()   # where a tensor index stands in a spec


def _full_index(spec, dyn):
    it = iter(dyn)
    return tuple(next(it) if s is _AT else s for s in spec)


def _getitem_impl(x, *dyn, spec):
    return x[_full_index(spec, dyn)]


def _split_index(idx):
    """(the static parts with ``_AT`` at each tensor's place, the
    tensors)."""
    spec, dyn = [], []
    for it in idx:
        if isinstance(it, torch.Tensor):
            spec.append(_AT)
            dyn.append(it)
        else:
            spec.append(it)
    return tuple(spec), dyn


def getitem(x, idx):
    x = ensure_tensor(x)
    spec, dyn = _split_index(_index(idx, raw(x).device))
    return dispatch("getitem", _getitem_impl, x, *dyn, spec=spec)


def _setitem_impl(x, v, *dyn, spec):
    out = x.clone()
    out[_full_index(spec, dyn)] = v
    return out


def setitem(x, idx, value):
    v = raw(x)
    value = ensure_tensor(value, ref=x)
    if raw(value).dtype != v.dtype or raw(value).device != v.device:
        value = Tensor._wrap(raw(value).to(device=v.device, dtype=v.dtype))
    spec, dyn = _split_index(_index(idx, v.device))
    out = dispatch("setitem", _setitem_impl, x, value, *dyn, spec=spec)
    x._value = raw(out)
    return x
