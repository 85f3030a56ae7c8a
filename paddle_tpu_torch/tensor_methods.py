"""The ops as methods of ``Tensor``, paddle-style (counterpart:
``paddle_tpu/tensor_methods.py``). Only the port's own ``Tensor`` class
is patched, never ``torch.Tensor``."""
from __future__ import annotations

import torch

from .ops import (collect_public_ops, comparison, indexing, linalg,
                  manipulation, math)
from .tensor import Tensor


def _attach():
    for name, fn in collect_public_ops().items():
        if not hasattr(Tensor, name):
            setattr(Tensor, name, fn)

    # operators -------------------------------------------------------------
    Tensor.__add__ = lambda s, o: math.add(s, o)
    Tensor.__radd__ = lambda s, o: math.add(o, s)
    Tensor.__sub__ = lambda s, o: math.subtract(s, o)
    Tensor.__rsub__ = lambda s, o: math.subtract(o, s)
    Tensor.__mul__ = lambda s, o: math.multiply(s, o)
    Tensor.__rmul__ = lambda s, o: math.multiply(o, s)
    Tensor.__truediv__ = lambda s, o: math.divide(s, o)
    Tensor.__rtruediv__ = lambda s, o: math.divide(o, s)
    Tensor.__floordiv__ = lambda s, o: math.floor_divide(s, o)
    Tensor.__rfloordiv__ = lambda s, o: math.floor_divide(o, s)
    Tensor.__mod__ = lambda s, o: math.mod(s, o)
    Tensor.__rmod__ = lambda s, o: math.mod(o, s)
    Tensor.__pow__ = lambda s, o: math.pow(s, o)
    Tensor.__rpow__ = lambda s, o: math.pow(o, s)
    Tensor.__matmul__ = lambda s, o: linalg.matmul(s, o)
    Tensor.__rmatmul__ = lambda s, o: linalg.matmul(o, s)
    Tensor.__neg__ = lambda s: math.neg(s)
    Tensor.__abs__ = lambda s: math.abs(s)
    Tensor.__invert__ = lambda s: (comparison.logical_not(s)
                                   if s._value.dtype == torch.bool
                                   else comparison.bitwise_not(s))
    Tensor.__and__ = lambda s, o: comparison.bitwise_and(s, o)
    Tensor.__or__ = lambda s, o: comparison.bitwise_or(s, o)
    Tensor.__xor__ = lambda s, o: comparison.bitwise_xor(s, o)

    Tensor.__eq__ = lambda s, o: comparison.equal(s, o)
    Tensor.__ne__ = lambda s, o: comparison.not_equal(s, o)
    Tensor.__lt__ = lambda s, o: comparison.less_than(s, o)
    Tensor.__le__ = lambda s, o: comparison.less_equal(s, o)
    Tensor.__gt__ = lambda s, o: comparison.greater_than(s, o)
    Tensor.__ge__ = lambda s, o: comparison.greater_equal(s, o)
    Tensor.__hash__ = lambda s: id(s)  # elementwise __eq__: identity hash

    Tensor.__getitem__ = lambda s, idx: indexing.getitem(s, idx)
    Tensor.__setitem__ = lambda s, idx, v: indexing.setitem(s, idx, v)

    # named methods beyond the collected set --------------------------------
    Tensor.astype = lambda s, dtype: manipulation.cast(s, dtype)
    Tensor.cast = Tensor.astype
    Tensor.dim = lambda s: s.ndim
    Tensor.rank = lambda s: s.ndim
    Tensor.numel = lambda s: s.size
    Tensor.add_ = _make_inplace(math.add)
    Tensor.subtract_ = _make_inplace(math.subtract)
    Tensor.multiply_ = _make_inplace(math.multiply)
    Tensor.divide_ = _make_inplace(math.divide)
    Tensor.scale_ = _make_inplace(math.scale)
    Tensor.clip_ = _make_inplace(math.clip)
    Tensor.zero_ = _zero_
    Tensor.fill_ = _fill_
    Tensor.exp_ = _make_inplace(math.exp)
    Tensor.floor_ = _make_inplace(math.floor)
    Tensor.ceil_ = _make_inplace(math.ceil)
    Tensor.round_ = _make_inplace(math.round)
    Tensor.sqrt_ = _make_inplace(math.sqrt)
    Tensor.rsqrt_ = _make_inplace(math.rsqrt)
    Tensor.reciprocal_ = _make_inplace(math.reciprocal)
    Tensor.remainder_ = _make_inplace(math.remainder)
    Tensor.tanh_ = _make_inplace(math.tanh)
    Tensor.erfinv_ = _make_inplace(math.erfinv)
    Tensor.lerp_ = _make_inplace(math.lerp)
    Tensor.flatten_ = _make_inplace(manipulation.flatten)
    Tensor.transpose_ = _make_inplace(manipulation.transpose)
    Tensor.masked_fill_ = _make_inplace(manipulation.masked_fill)
    Tensor.put_along_axis_ = _make_inplace(manipulation.put_along_axis)
    Tensor.bool = lambda s: s.astype("bool")
    Tensor.float = lambda s: s.astype("float32")
    Tensor.int = lambda s: s.astype("int32")
    Tensor.long = lambda s: s.astype("int64")
    Tensor.ndimension = lambda s: s.ndim
    Tensor.element_size = lambda s: s._value.element_size()
    Tensor.nbytes = property(lambda s: s._value.element_size()
                             * s._value.numel())
    Tensor.gradient = lambda s: None if s.grad is None else s.grad.numpy()
    Tensor.value = lambda s: s
    Tensor.T = property(lambda s: manipulation.transpose(s))
    Tensor.mT = property(lambda s: manipulation.transpose(
        s, list(range(s.ndim - 2)) + [s.ndim - 1, s.ndim - 2]))


def _make_inplace(fn):
    """``x.op_(...)``: the reference's payload replacement (the result
    takes the tensor's place; its graph comes with it)."""
    def method(self, *args, **kwargs):
        out = fn(self, *args, **kwargs)
        self._value = out._value
        return self
    return method


def _zero_(self):
    return self._replace(torch.zeros_like(self._value.detach()))


def _fill_(self, value):
    return self._replace(torch.full_like(self._value.detach(), value))


_attach()
