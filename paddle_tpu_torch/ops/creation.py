"""Tensor creation ops (counterpart: ``paddle_tpu/ops/creation.py``).

A new tensor lands on the current place (``framework/place.py``): the
card unless ``paddle.set_device("cpu")`` was called, and without a card
that raises. Float creation defaults to the default float dtype
(float32); ``arange`` over ints gives int64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.place import current_device
from ..tensor import Tensor
from .common import ensure_tensor, int_list, raw, scalar_of
from .dispatch import dispatch


def _shape_tuple(shape):
    return tuple(int_list(shape))


def _dt(dtype, default=None):
    if dtype is None:
        dtype = default or dtype_mod.default_float()
    return dtype_mod.to_torch_dtype(dtype)


def _new(v):
    return Tensor._wrap(v)


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros(_shape_tuple(shape), dtype=_dt(dtype),
                            device=current_device()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones(_shape_tuple(shape), dtype=_dt(dtype),
                           device=current_device()))


def full(shape, fill_value, dtype=None, name=None):
    """Float unless ``dtype`` says otherwise (a bool fill gives bool), as
    in the reference."""
    if dtype is None and isinstance(fill_value, bool):
        dtype = "bool"
    return _new(torch.full(_shape_tuple(shape), scalar_of(fill_value),
                           dtype=_dt(dtype), device=current_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(x, dtype):
    v = raw(ensure_tensor(x))
    return v, (v.dtype if dtype is None else dtype_mod.to_torch_dtype(dtype))


def zeros_like(x, dtype=None, name=None):
    v, td = _like(x, dtype)
    return _new(torch.zeros(v.shape, dtype=td, device=v.device))


def ones_like(x, dtype=None, name=None):
    v, td = _like(x, dtype)
    return _new(torch.ones(v.shape, dtype=td, device=v.device))


def full_like(x, fill_value, dtype=None, name=None):
    v, td = _like(x, dtype)
    return _new(torch.full(v.shape, scalar_of(fill_value), dtype=td,
                           device=v.device))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = scalar_of(start), scalar_of(end), scalar_of(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else dtype_mod.default_float())
    # computed in float64 on the host and cast, as NumPy (and the
    # reference) compute it
    vals = np.arange(start, end, step)
    return _new(torch.from_numpy(np.ascontiguousarray(vals)).to(
        device=current_device(), dtype=_dt(dtype)))


def linspace(start, stop, num, dtype=None, name=None):
    vals = np.linspace(float(scalar_of(start)), float(scalar_of(stop)),
                       int(scalar_of(num)))
    return _new(torch.from_numpy(vals).to(device=current_device(),
                                          dtype=_dt(dtype)))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    vals = np.logspace(float(start), float(stop), int(num), base=float(base))
    return _new(torch.from_numpy(vals).to(device=current_device(),
                                          dtype=_dt(dtype)))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return _new(torch.eye(n, m, dtype=_dt(dtype), device=current_device()))


def _tril_impl(x, diagonal):
    return torch.tril(x, diagonal)


def _triu_impl(x, diagonal):
    return torch.triu(x, diagonal)


def tril(x, diagonal=0, name=None):
    return dispatch("tril", _tril_impl, ensure_tensor(x),
                    diagonal=int(diagonal))


def triu(x, diagonal=0, name=None):
    return dispatch("triu", _triu_impl, ensure_tensor(x),
                    diagonal=int(diagonal))


def _diag_impl(x, offset, padding_value):
    if x.ndim == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
            out = torch.where(mask, out, torch.full_like(out, padding_value))
        return out
    return torch.diagonal(x, offset)


def diag(x, offset=0, padding_value=0, name=None):
    return dispatch("diag", _diag_impl, ensure_tensor(x), offset=int(offset),
                    padding_value=padding_value)


def diagflat(x, offset=0, name=None):
    from .manipulation import flatten
    return diag(flatten(x), offset=offset)


def _assign_impl(x):
    return x.clone()


def assign(x, output=None):
    t = dispatch("assign", _assign_impl, ensure_tensor(x))
    if output is not None:
        output._value = raw(t)
        return output
    return t


def clone(x, name=None):
    return assign(x)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    ts = [ensure_tensor(a) for a in args]
    return list(dispatch("meshgrid", _meshgrid_impl, *ts))


def _meshgrid_impl(*vals):
    return tuple(torch.meshgrid(*vals, indexing="ij"))


def _complex_impl(r, i):
    return torch.complex(r, i)


def complex(real, imag, name=None):
    from .common import binary_args
    return dispatch("complex", _complex_impl, *binary_args(real, imag))


def _as_complex_impl(v):
    return torch.view_as_complex(v.contiguous())


def as_complex(x, name=None):
    return dispatch("as_complex", _as_complex_impl, ensure_tensor(x))


def _as_real_impl(v):
    return torch.view_as_real(v)


def as_real(x, name=None):
    return dispatch("as_real", _as_real_impl, ensure_tensor(x))


def _real_impl(v):
    return torch.real(v)


def real(x, name=None):
    return dispatch("real", _real_impl, ensure_tensor(x))


def _imag_impl(v):
    return torch.imag(v)


def imag(x, name=None):
    return dispatch("imag", _imag_impl, ensure_tensor(x))


def tril_indices(row, col, offset=0, dtype="int64"):
    return _new(torch.tril_indices(int(row), int(col), int(offset),
                                   device=current_device(),
                                   dtype=_dt(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return _new(torch.triu_indices(int(row), int(col), int(offset),
                                   device=current_device(),
                                   dtype=_dt(dtype)))

