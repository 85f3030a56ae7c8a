"""Comparison, logical and bitwise ops (counterpart:
``paddle_tpu/ops/comparison.py``). Their outputs are never
differentiable; the element-wise families are generated from the op
table."""
from __future__ import annotations

import torch

from ..tensor import Tensor
from .common import binary_args, ensure_tensor, raw
from .dispatch import nondiff
from .registry import generate_ops as _generate_ops

globals().update(_generate_ops("compare"))
globals().update(_generate_ops("compare1", ["logical_not", "bitwise_not"]))


def _isclose_impl(x, y, rtol, atol, equal_nan):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = binary_args(x, y)
    return nondiff("isclose", _isclose_impl, x, y, rtol=float(rtol),
                   atol=float(atol), equal_nan=bool(equal_nan))


def _allclose_impl(x, y, rtol, atol, equal_nan):
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = binary_args(x, y)
    return nondiff("allclose", _allclose_impl, x, y, rtol=float(rtol),
                   atol=float(atol), equal_nan=bool(equal_nan))


def _equal_all_impl(x, y):
    return torch.tensor(x.shape == y.shape and bool(torch.equal(x, y)),
                        device=x.device)


def equal_all(x, y, name=None):
    x, y = binary_args(x, y)
    return nondiff("equal_all", _equal_all_impl, x, y)


def _isin_impl(x, test):
    return torch.isin(x, test)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    x = ensure_tensor(x)
    out = nondiff("isin", _isin_impl, x, ensure_tensor(test_x, ref=x))
    return logical_not(out) if invert else out  # noqa: F821


def is_empty(x, name=None):
    x = ensure_tensor(x)
    return Tensor._wrap(torch.tensor(raw(x).numel() == 0,
                                     device=raw(x).device))
