"""The dtype system of the ``paddle.*`` surface (counterpart:
``paddle_tpu/framework/dtype.py``).

A ``DType`` names a ``torch.dtype`` (the reference's wraps a numpy
dtype). It compares equal to every spelling a user may pass: another
``DType``, its name ("float32", "bool"), a numpy dtype or scalar type,
or the ``torch.dtype`` itself. NumPy has no bfloat16, so
``DType.np_dtype`` of ``bfloat16`` is None.
"""
from __future__ import annotations

import numpy as np
import torch


class DType:
    """A paddle dtype: ``paddle.float32``, ``paddle.bfloat16``, ..."""

    __slots__ = ("name", "torch_dtype")

    def __init__(self, name, torch_dtype):
        self.name = name
        self.torch_dtype = torch_dtype

    def __repr__(self):
        return f"paddle.{self.name}"

    __str__ = __repr__

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        try:
            return self.name == _name_of(other)
        except TypeError:
            return NotImplemented

    def __ne__(self, other):
        res = self.__eq__(other)
        return res if res is NotImplemented else not res

    @property
    def np_dtype(self):
        return None if self.name == "bfloat16" else np.dtype(self.name)

    @property
    def is_floating_point(self):
        return self.torch_dtype.is_floating_point

    @property
    def is_complex(self):
        return self.torch_dtype.is_complex

    @property
    def is_integer(self):
        return not (self.torch_dtype.is_floating_point
                    or self.torch_dtype.is_complex
                    or self.torch_dtype == torch.bool)


bfloat16 = DType("bfloat16", torch.bfloat16)
float16 = DType("float16", torch.float16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
uint8 = DType("uint8", torch.uint8)
bool_ = DType("bool", torch.bool)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)

_ALL = [bfloat16, float16, float32, float64, int8, int16, int32, int64,
        uint8, bool_, complex64, complex128]
_BY_NAME = {d.name: d for d in _ALL}
_BY_TORCH = {d.torch_dtype: d for d in _ALL}


def _name_of(dtype):
    """The canonical name of any dtype spelling (raises TypeError)."""
    if dtype is None:
        raise TypeError("dtype is None")
    if isinstance(dtype, DType):
        return dtype.name
    if isinstance(dtype, torch.dtype):
        if dtype not in _BY_TORCH:
            raise TypeError(f"unsupported dtype: {dtype!r}")
        return _BY_TORCH[dtype].name
    if isinstance(dtype, str):
        s = dtype[len("paddle."):] if dtype.startswith("paddle.") else dtype
        if s in _BY_NAME:
            return s
        dtype = s
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise TypeError(f"unsupported dtype: {dtype!r}") from None
    if name not in _BY_NAME:
        raise TypeError(f"unsupported dtype: {dtype!r}")
    return name


def to_paddle_dtype(dtype) -> DType:
    return _BY_NAME[_name_of(dtype)]


def to_torch_dtype(dtype) -> torch.dtype:
    return _BY_NAME[_name_of(dtype)].torch_dtype


# Paddle's defaults: float32 for floats (switchable), int64 for python ints.
_default_float = float32


def set_default_dtype(d):
    global _default_float
    d = to_paddle_dtype(d)
    if not d.is_floating_point:
        raise TypeError(f"default dtype must be floating, got {d}")
    _default_float = d


def get_default_dtype() -> str:
    return _default_float.name


def default_float() -> DType:
    return _default_float


class iinfo:
    """paddle.iinfo: the limits of an integer dtype."""

    def __init__(self, dtype):
        info = torch.iinfo(to_torch_dtype(dtype))
        self.min = int(info.min)
        self.max = int(info.max)
        self.bits = int(info.bits)
        self.dtype = to_paddle_dtype(dtype).name


class finfo:
    """paddle.finfo: the limits of a floating dtype (bfloat16 too)."""

    def __init__(self, dtype):
        info = torch.finfo(to_torch_dtype(dtype))
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.tiny)
        self.smallest_normal = float(info.smallest_normal)
        self.resolution = float(info.resolution)
        self.bits = int(info.bits)
        self.dtype = to_paddle_dtype(dtype).name
