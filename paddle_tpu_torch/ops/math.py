"""Element-wise math, reductions and the cumulative family (counterpart:
``paddle_tpu/ops/math.py``).

The element-wise unary and binary families are generated from the op
table (``registry.generate_ops``); the ops below carry attributes or
their own promotion. ``add`` and ``matmul`` are the ops the models
route through the per-op seam: called with torch tensors they run as
before (torch's promotion, one dispatch), so an ``auto_cast`` block casts
their inputs as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..tensor import Tensor
from .common import (binary_args, default_float, dims, ensure_tensor,
                     is_float, norm_axis, raw, scalar_of, single_axis)
from .dispatch import dispatch, nondiff
from .registry import generate_ops as _generate_ops

globals().update(_generate_ops("binary"))
globals().update(_generate_ops("unary"))
globals().update(_generate_ops("compare1", ["isnan", "isinf", "isfinite"]))
remainder = mod       # noqa: F821  (generated above)
floor_mod = mod       # noqa: F821
sgn = sign            # noqa: F821


def _matmul_impl(x, y, transpose_x, transpose_y):
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return x @ y


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)):
        x, y = binary_args(x, y)
    return dispatch("matmul", _matmul_impl, x, y,
                    transpose_x=bool(transpose_x),
                    transpose_y=bool(transpose_y))


def _pow_impl(x, y):
    return torch.pow(x, y)


def pow(x, y, name=None):
    if isinstance(y, (int, float)) and not isinstance(y, bool):
        x = ensure_tensor(x)
        if not is_float(raw(x)) and isinstance(y, float):
            x = _cast(x, default_float())
        return dispatch("pow_scalar", _pow_impl, x, y)
    x, y = binary_args(x, y)
    return dispatch("pow", _pow_impl, x, y)


def _cast(x, td):
    from .manipulation import cast
    return cast(x, td)


def _scale_impl(x, scale, bias, bias_after_scale):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    out = dispatch("scale", _scale_impl, ensure_tensor(x),
                   scale=float(scalar_of(scale)), bias=float(bias),
                   bias_after_scale=bool(bias_after_scale))
    if act is not None:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def _clip_impl(x, lo, hi):
    return torch.clamp(x, lo, hi)


def clip(x, min=None, max=None, name=None):
    """Bounds are floats, as in the reference: an integer tensor comes
    back float64 (ROADMAP C)."""
    x = ensure_tensor(x)
    lo = -np.inf if min is None else float(scalar_of(min))
    hi = np.inf if max is None else float(scalar_of(max))
    if not is_float(raw(x)):
        x = _cast(x, torch.float64)
    return dispatch("clip", _clip_impl, x, lo=lo, hi=hi)


def _lerp_impl(x, y, w):
    return x + w * (y - x)


def lerp(x, y, weight, name=None):
    x, y = binary_args(x, y)
    w = ensure_tensor(weight, ref=x)
    return dispatch("lerp", _lerp_impl, x, y, w)


def _logit_impl(x, eps):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def logit(x, eps=None, name=None):
    return dispatch("logit", _logit_impl, ensure_tensor(x), eps=eps)


def _stanh_impl(x, scale_a, scale_b):
    return scale_b * torch.tanh(scale_a * x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return dispatch("stanh", _stanh_impl, ensure_tensor(x),
                    scale_a=float(scale_a), scale_b=float(scale_b))


def _multiplex_impl(index, *ins):
    stacked = torch.stack(ins, 0)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[index.reshape(-1).long(), rows]


def multiplex(inputs, index, name=None):
    return dispatch("multiplex", _multiplex_impl, ensure_tensor(index),
                    *[ensure_tensor(t) for t in inputs])


# ------------------------------------------------------------- reductions ---
def _sum_impl(x, axis, keepdim, dtype):
    return torch.sum(x, dim=dims(axis, x), keepdim=keepdim, dtype=dtype)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    v = raw(x)
    td = dtype_mod.to_torch_dtype(dtype) if dtype is not None else (
        torch.int64 if v.dtype == torch.bool else None)
    return dispatch("sum", _sum_impl, x, axis=norm_axis(axis, v.ndim),
                    keepdim=bool(keepdim), dtype=td)


def _nansum_impl(x, axis, keepdim):
    return torch.nansum(x, dim=dims(axis, x), keepdim=keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return dispatch("nansum", _nansum_impl, x,
                    axis=norm_axis(axis, raw(x).ndim), keepdim=bool(keepdim))


def _mean_impl(x, axis, keepdim):
    if not is_float(x):
        x = x.to(default_float())
    return torch.mean(x, dim=dims(axis, x), keepdim=keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return dispatch("mean", _mean_impl, x,
                    axis=norm_axis(axis, raw(x).ndim), keepdim=bool(keepdim))


def _nanmean_impl(x, axis, keepdim):
    return torch.nanmean(x, dim=dims(axis, x), keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return dispatch("nanmean", _nanmean_impl, x,
                    axis=norm_axis(axis, raw(x).ndim), keepdim=bool(keepdim))


def _max_impl(x, axis, keepdim):
    return torch.amax(x, dim=dims(axis, x), keepdim=keepdim)


def _min_impl(x, axis, keepdim):
    return torch.amin(x, dim=dims(axis, x), keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return dispatch("max", _max_impl, x, axis=norm_axis(axis, raw(x).ndim),
                    keepdim=bool(keepdim))


def min(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return dispatch("min", _min_impl, x, axis=norm_axis(axis, raw(x).ndim),
                    keepdim=bool(keepdim))


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def _prod_impl(x, axis, keepdim, dtype):
    if axis is None:
        out = torch.prod(x.reshape(-1), 0, dtype=dtype)
        return out.reshape([1] * x.ndim) if keepdim else out
    out = x if dtype is None else x.to(dtype)
    for a in sorted(axis, reverse=True):
        out = torch.prod(out, a, keepdim=keepdim)
    if dtype is None and not is_float(x):
        out = out.to(torch.int64)
    return out


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = ensure_tensor(x)
    return dispatch("prod", _prod_impl, x,
                    axis=norm_axis(axis, raw(x).ndim), keepdim=bool(keepdim),
                    dtype=dtype_mod.to_torch_dtype(dtype) if dtype else None)


def _all_impl(x, axis, keepdim):
    return torch.all(x.bool(), dim=dims(axis, x), keepdim=keepdim) \
        if x.ndim else x.bool()


def _any_impl(x, axis, keepdim):
    return torch.any(x.bool(), dim=dims(axis, x), keepdim=keepdim) \
        if x.ndim else x.bool()


def all(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return nondiff("all", _all_impl, x, axis=norm_axis(axis, raw(x).ndim),
                   keepdim=bool(keepdim))


def any(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return nondiff("any", _any_impl, x, axis=norm_axis(axis, raw(x).ndim),
                   keepdim=bool(keepdim))


def _logsumexp_impl(x, axis, keepdim):
    return torch.logsumexp(x, dim=dims(axis, x), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return dispatch("logsumexp", _logsumexp_impl, x,
                    axis=norm_axis(axis, raw(x).ndim), keepdim=bool(keepdim))


def _std_impl(x, axis, unbiased, keepdim):
    return torch.std(x, dim=dims(axis, x), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = ensure_tensor(x)
    return dispatch("std", _std_impl, x, axis=norm_axis(axis, raw(x).ndim),
                    unbiased=bool(unbiased), keepdim=bool(keepdim))


def _var_impl(x, axis, unbiased, keepdim):
    return torch.var(x, dim=dims(axis, x), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = ensure_tensor(x)
    return dispatch("var", _var_impl, x, axis=norm_axis(axis, raw(x).ndim),
                    unbiased=bool(unbiased), keepdim=bool(keepdim))


def _quantile_impl(x, q, axis, keepdim, nan):
    fn = torch.nanquantile if nan else torch.quantile
    qt = torch.tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), qt, dim=0)
        return out.reshape(out.shape + (1,) * x.ndim) if keepdim else out
    if len(axis) == 1:
        return fn(x, qt, dim=axis[0], keepdim=keepdim)
    rest = [a for a in range(x.ndim) if a not in axis]
    moved = x.permute(rest + list(axis)).reshape(
        [x.shape[a] for a in rest] + [-1])
    out = fn(moved, qt, dim=-1)
    if keepdim:
        for a in sorted(axis):
            out = out.unsqueeze(a + (1 if qt.ndim else 0))
    return out


def _quantile(name, x, q, axis, keepdim):
    x = ensure_tensor(x)
    v = raw(x)
    ax = None if axis is None else norm_axis(axis, v.ndim)
    if not is_float(v):
        x = _cast(x, default_float())
    return dispatch(name, _quantile_impl, x,
                    q=float(q) if isinstance(q, (int, float)) else
                    [float(a) for a in q],
                    axis=ax, keepdim=bool(keepdim), nan=name != "quantile")


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile("quantile", x, q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile("nanquantile", x, q, axis, keepdim)


def median(x, axis=None, keepdim=False, name=None):
    """The mean of the two middle values on an even count (NumPy's rule,
    as in the reference), not torch's lower one."""
    return quantile(x, 0.5, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return nanquantile(x, 0.5, axis, keepdim)


# ------------------------------------------------------------- cumulative ---
def _flat_axis(x, axis):
    if axis is None:
        from .manipulation import flatten
        return flatten(x), 0
    return x, single_axis(axis, raw(x).ndim)


def _cumsum_impl(x, axis):
    return torch.cumsum(x, axis, dtype=x.dtype if x.dtype != torch.bool
                        else torch.int64)


def cumsum(x, axis=None, dtype=None, name=None):
    x, axis = _flat_axis(ensure_tensor(x), axis)
    out = dispatch("cumsum", _cumsum_impl, x, axis=axis)
    return out if dtype is None else _cast(out, dtype)


def _cumprod_impl(x, dim):
    return torch.cumprod(x, dim, dtype=x.dtype)


def cumprod(x, dim=None, dtype=None, name=None):
    x, dim = _flat_axis(ensure_tensor(x), dim)
    out = dispatch("cumprod", _cumprod_impl, x, dim=dim)
    return out if dtype is None else _cast(out, dtype)


def _cummax_impl(x, axis):
    v, i = torch.cummax(x, axis)
    return v, i


def _cummin_impl(x, axis):
    v, i = torch.cummin(x, axis)
    return v, i


def cummax(x, axis=None, dtype="int64", name=None):
    """Values and the index of the last occurrence of each running
    maximum."""
    x, axis = _flat_axis(ensure_tensor(x), axis)
    vals, idx = dispatch("cummax", _cummax_impl, x, axis=axis)
    return vals, _cast(idx, dtype_mod.to_torch_dtype(dtype))


def cummin(x, axis=None, dtype="int64", name=None):
    x, axis = _flat_axis(ensure_tensor(x), axis)
    vals, idx = dispatch("cummin", _cummin_impl, x, axis=axis)
    return vals, _cast(idx, dtype_mod.to_torch_dtype(dtype))


def _logcumsumexp_impl(x, axis):
    return torch.logcumsumexp(x, axis)


def logcumsumexp(x, axis=None, name=None):
    x, axis = _flat_axis(ensure_tensor(x), axis)
    return dispatch("logcumsumexp", _logcumsumexp_impl, x, axis=axis)


def _diff_impl(x, n, axis):
    return torch.diff(x, n=n, dim=axis)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    from .manipulation import concat
    if prepend is not None or append is not None:
        parts = ([prepend] if prepend is not None else []) + [x] + (
            [append] if append is not None else [])
        x = concat(parts, axis=axis)
    return dispatch("diff", _diff_impl, ensure_tensor(x), n=int(n),
                    axis=int(axis))


def _trace_impl(x, offset, axis1, axis2):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return dispatch("trace", _trace_impl, ensure_tensor(x),
                    offset=int(offset), axis1=int(axis1), axis2=int(axis2))


def _diagonal_impl(x, offset, axis1, axis2):
    return torch.diagonal(x, offset, axis1, axis2)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return dispatch("diagonal", _diagonal_impl, ensure_tensor(x),
                    offset=int(offset), axis1=int(axis1), axis2=int(axis2))


def _kron_impl(x, y):
    return torch.kron(x, y)


def kron(x, y, name=None):
    x, y = binary_args(x, y)
    return dispatch("kron", _kron_impl, x, y)


def _inner_impl(x, y):
    return torch.inner(x, y)


def inner(x, y, name=None):
    x, y = binary_args(x, y)
    return dispatch("inner", _inner_impl, x, y)


def _outer_impl(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


def outer(x, y, name=None):
    x, y = binary_args(x, y)
    return dispatch("outer", _outer_impl, x, y)


def _addmm_impl(inp, x, y, beta, alpha):
    return beta * inp + alpha * (x @ y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return dispatch("addmm", _addmm_impl, ensure_tensor(input),
                    ensure_tensor(x), ensure_tensor(y), beta=float(beta),
                    alpha=float(alpha))


def increment(x, value=1.0, name=None):
    """``x += value`` by payload replacement, as in the reference."""
    out = add(x, value)  # noqa: F821  (generated above)
    x._replace(raw(out))
    return x


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    from .manipulation import cast
    return sum(cast(_nonzero_mask(x), "int64"), axis=axis, keepdim=keepdim)


def _nonzero_mask(x):
    from .comparison import not_equal
    return not_equal(x, 0)


# ---------------------------------------------------------- numeric tail ---
def _ldexp_impl(x, y):
    if not is_float(x):
        x = x.to(torch.float32)
    return x * torch.exp2(y.to(x.dtype))


def ldexp(x, y, name=None):
    return dispatch("ldexp", _ldexp_impl, ensure_tensor(x), ensure_tensor(y))


def _nan_to_num_impl(x, nan, posinf, neginf):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return dispatch("nan_to_num", _nan_to_num_impl, ensure_tensor(x),
                    nan=float(nan),
                    posinf=None if posinf is None else float(posinf),
                    neginf=None if neginf is None else float(neginf))


def _renorm_impl(x, p, axis, max_norm):
    moved = x.movedim(axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.sum(flat.abs() ** p, 1) ** (1.0 / p)
    scale = torch.where(norms > max_norm,
                        max_norm / torch.clamp(norms, min=1e-12),
                        torch.ones_like(norms))
    return (flat * scale[:, None]).reshape(moved.shape).movedim(0, axis)


def renorm(x, p, axis, max_norm, name=None):
    x = ensure_tensor(x)
    return dispatch("renorm", _renorm_impl, x, p=float(p),
                    axis=single_axis(axis, raw(x).ndim),
                    max_norm=float(max_norm))


def _signbit_impl(x):
    return torch.signbit(x)


def signbit(x, name=None):
    return nondiff("signbit", _signbit_impl, ensure_tensor(x))


def _vander_impl(x, n, increasing):
    return torch.linalg.vander(x, N=n).flip(-1) if not increasing \
        else torch.linalg.vander(x, N=n)


def vander(x, n=None, increasing=False, name=None):
    x = ensure_tensor(x)
    if raw(x).ndim != 1:
        raise ValueError("vander expects a 1-D tensor")
    n = raw(x).shape[0] if n is None else int(n)
    return dispatch("vander", _vander_impl, x, n=n,
                    increasing=bool(increasing))


def inverse(x, name=None):
    from .linalg import inv
    return inv(x)


def is_complex(x):
    return raw(ensure_tensor(x)).is_complex()


def is_floating_point(x):
    return raw(ensure_tensor(x)).is_floating_point()


def is_integer(x):
    v = raw(ensure_tensor(x))
    return not (v.is_floating_point() or v.is_complex()
                or v.dtype == torch.bool)


def _sinc_impl(x):
    return torch.sinc(x)


def sinc(x, name=None):
    return dispatch("sinc", _sinc_impl, ensure_tensor(x))


def _polar_impl(abs_v, angle):
    return torch.polar(abs_v, angle)


def polar(abs, angle, name=None):  # noqa: A002 - paddle arg name
    return dispatch("polar", _polar_impl, *binary_args(abs, angle))


def _frexp_impl(x):
    m, e = torch.frexp(x)
    return m, e


def frexp(x, name=None):
    return nondiff("frexp", _frexp_impl, ensure_tensor(x))


def _isneginf_impl(x):
    return torch.isneginf(x)


def isneginf(x, name=None):
    return nondiff("isneginf", _isneginf_impl, ensure_tensor(x))


def _isposinf_impl(x):
    return torch.isposinf(x)


def isposinf(x, name=None):
    return nondiff("isposinf", _isposinf_impl, ensure_tensor(x))


def _isreal_impl(x):
    return torch.isreal(x)


def isreal(x, name=None):
    return nondiff("isreal", _isreal_impl, ensure_tensor(x))


def positive(x, name=None):
    x = ensure_tensor(x)
    if raw(x).dtype == torch.bool:
        raise TypeError("positive does not support bool tensors")
    return x

