"""Shared helpers of the op library: operand conversion, the reference's
dtype promotion and axis normalization (counterpart:
``paddle_tpu/ops/common.py``).

An op takes paddle Tensors, torch tensors, numbers or arrays. With a
torch tensor among its operands and no paddle Tensor it stays in torch
(the models' calls); otherwise numbers and arrays become paddle Tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..tensor import Tensor



def raw(x):
    """The torch tensor under a paddle Tensor (a torch tensor as it is)."""
    return x._value if isinstance(x, Tensor) else x


def is_tensor_like(x):
    return isinstance(x, (Tensor, torch.Tensor))


def ensure_tensor(x, ref=None):
    """A tensor for ``x``: paddle Tensors and torch tensors as they are;
    Python scalars given a ``ref`` tensor adopt its dtype family (an int
    scalar beside a float tensor takes the tensor's dtype; a float
    scalar beside an int tensor takes the default float) and its device,
    and are a torch tensor when ``ref`` is one; anything else becomes a
    paddle Tensor on the current place."""
    if isinstance(x, (Tensor, torch.Tensor)):
        return x
    if ref is not None and isinstance(x, (bool, int, float)):
        r = raw(ref)
        rdt = r.dtype
        if isinstance(x, bool):
            dt = torch.bool
        elif isinstance(x, int):
            dt = rdt if rdt != torch.bool else torch.int64
        elif rdt.is_floating_point or rdt.is_complex:
            dt = rdt
        else:
            dt = dtype_mod.default_float().torch_dtype
        v = torch.full((), x, dtype=dt, device=r.device)
        return v if isinstance(ref, torch.Tensor) else Tensor._wrap(v)
    device = raw(ref).device if ref is not None else None
    from .dispatch import unwrap
    return Tensor._wrap(unwrap(x, device=device))


def cast_to(t, td):
    """``t`` (paddle or torch) cast to the torch dtype ``td``, keeping its
    graph."""
    v = raw(t)
    if v.dtype == td:
        return t
    out = v.to(td)
    return Tensor._wrap(out) if isinstance(t, Tensor) else out


def promote(*ts):
    """The operands cast to their common dtype (the reference's
    ``jnp.promote_types`` lattice, which ``torch.promote_types`` follows
    for the dtypes both have)."""
    ct = raw(ts[0]).dtype
    for t in ts[1:]:
        ct = torch.promote_types(ct, raw(t).dtype)
    return tuple(cast_to(t, ct) for t in ts)


def binary_args(x, y):
    """Promote a binary op's operands to a common dtype, paddle-style."""
    xt, yt = is_tensor_like(x), is_tensor_like(y)
    if xt and not yt:
        y = ensure_tensor(y, ref=x)
    elif yt and not xt:
        x = ensure_tensor(x, ref=y)
    elif not xt:
        x = ensure_tensor(x)
        y = ensure_tensor(y, ref=x)
    if raw(x).device != raw(y).device:
        # a 0-d operand follows the other one's device, as torch allows
        if raw(y).ndim == 0:
            y = _to_device(y, raw(x).device)
        elif raw(x).ndim == 0:
            x = _to_device(x, raw(y).device)
    if raw(x).dtype != raw(y).dtype:
        x, y = promote(x, y)
    return x, y


def _to_device(t, device):
    v = raw(t).to(device)
    return Tensor._wrap(v) if isinstance(t, Tensor) else v


def tensor_list(xs):
    """Each element of ``xs`` as a tensor."""
    return tuple(ensure_tensor(t) for t in xs)


def norm_axis(axis, ndim):
    """Normalize an axis spec to a tuple of non-negative ints (None =
    all)."""
    if axis is None:
        return None
    if isinstance(axis, (Tensor, torch.Tensor)):
        axis = raw(axis).tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % ndim if ndim else int(a) for a in axis)
    a = int(axis)
    return (a % ndim if ndim else a,)


def single_axis(axis, ndim):
    if isinstance(axis, (Tensor, torch.Tensor)):
        axis = raw(axis).item()
    a = int(axis)
    return a % ndim if ndim and a < 0 else a


def dims(axis, x):
    """``axis`` (a normalized tuple or None) as torch's ``dim`` argument
    for the reductions: every dimension when None."""
    return tuple(range(x.ndim)) if axis is None else axis


def scalar_of(v):
    """A Python number from a number, a 0-d array or a one-element
    tensor."""
    if isinstance(v, (Tensor, torch.Tensor)):
        return raw(v).item()
    if isinstance(v, np.ndarray):
        return v.item()
    return v


def int_list(v):
    """A list of ints from an int, a sequence (of ints or 0-d tensors) or
    a tensor."""
    if isinstance(v, (Tensor, torch.Tensor)):
        return [int(s) for s in raw(v).reshape(-1).tolist()]
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(scalar_of(s)) for s in v]


def is_float(v):
    return v.is_floating_point() or v.is_complex()


def default_float():
    return dtype_mod.default_float().torch_dtype
