"""paddle.save / paddle.load of the port (counterpart:
``paddle_tpu/framework/io.py``): one pickle file per call, holding nested
dicts, lists and tuples of tensors and Python values (a ``state_dict``,
an optimizer's state, a training loop's own record).

- A tensor (a paddle ``Tensor``, a torch tensor, an ``nn.Parameter``) is
  saved as a ``_TensorPayload``: its values as a NumPy array on the host
  and its ``stop_gradient``. NumPy has no bfloat16, so a bf16 tensor's
  bits are saved as an int16 array tagged ``dtype="bfloat16"`` and come
  back exactly. NumPy arrays and Python values are saved as they are.
- ``load`` gives each payload back as a ``Tensor`` on the current place,
  as ``to_tensor`` makes one (the device rule of ``framework/place.py``),
  or as a NumPy array with ``return_numpy=True`` (bf16 widened to
  float32, exactly, as ``Tensor.numpy`` does).
- Files written by the JAX package load too, without importing it: the
  unpickler maps its ``_TensorPayload`` onto this module's and its
  ``ml_dtypes.bfloat16`` arrays onto bf16 (a bf16 array saved outside a
  tensor comes back as a bf16 torch tensor on the host), and refuses any
  other global of ``paddle_tpu`` or ``jax`` with an error naming it. The
  JAX package cannot read the port's files: its loader knows only its
  own payload class.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

from ..tensor import Tensor, to_tensor

__all__ = ["save", "load"]

_FOREIGN_ROOTS = ("paddle_tpu", "jax", "jaxlib")


class _TensorPayload:
    __slots__ = ("array", "stop_gradient", "dtype")

    def __init__(self, array, stop_gradient, dtype=None):
        self.array = array
        self.stop_gradient = stop_gradient
        self.dtype = dtype


class _BFloat16:
    """Stands for ``ml_dtypes.bfloat16`` while a file is read."""


def host_array(value, copy=False):
    """(NumPy array, dtype tag) of a torch tensor's values on the host: a
    bf16 tensor as its int16 bits with the tag "bfloat16", any other
    dtype as itself with None. The device-to-host copy is a blocking one;
    ``copy=True`` also copies a tensor already on the host, so the array
    shares nothing with it."""
    v = value.detach()
    v = v.to("cpu", copy=True) if copy else v.cpu()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy(), "bfloat16"
    return v.numpy(), None


def _pack(obj):
    if isinstance(obj, Tensor):
        array, tag = host_array(obj._value)
        return _TensorPayload(array, obj.stop_gradient, tag)
    if isinstance(obj, torch.Tensor):
        array, tag = host_array(obj)
        return _TensorPayload(array, not obj.requires_grad, tag)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    """Reads the port's files and the JAX package's, importing neither
    JAX nor the JAX package. ``bf16_dtypes`` holds the dtype objects that
    stand for ``ml_dtypes.bfloat16`` in this file."""

    def __init__(self, f):
        super().__init__(f)
        self.bf16_dtypes = []

    def find_class(self, module, name):
        if (module, name) == ("paddle_tpu.framework.io", "_TensorPayload"):
            return _TensorPayload
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _BFloat16
        if (module, name) == ("numpy", "dtype"):
            return self._dtype
        if module.split(".")[0] in _FOREIGN_ROOTS:
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}, which the PyTorch "
                "port does not read (it imports neither jax nor paddle_tpu)")
        return super().find_class(module, name)

    def _dtype(self, obj, *args):
        if obj is _BFloat16:
            # two raw bytes an element; the array's bits are read as bf16
            d = np.dtype("V2")
            self.bf16_dtypes.append(d)
            return d
        return np.dtype(obj, *args)

    def is_bf16(self, array):
        return isinstance(array, np.ndarray) and any(
            array.dtype is d for d in self.bf16_dtypes)


def read_pickle(data):
    """(object, unpickler) of pickled bytes written by either package."""
    up = _Unpickler(io.BytesIO(data))
    return up.load(), up


def bf16_tensor(array):
    """A bf16 host tensor over ``array``'s 16-bit patterns (an int16 or
    uint16 array, or the raw two-byte elements of an ml_dtypes bf16
    array)."""
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int16)) \
        .view(torch.bfloat16)


def _unpack(obj, return_numpy, up):
    if isinstance(obj, _TensorPayload):
        array = obj.array
        if getattr(obj, "dtype", None) == "bfloat16" or up.is_bf16(array):
            value = bf16_tensor(array)
            if return_numpy:
                return value.float().numpy()
        elif return_numpy:
            return array
        else:
            value = torch.from_numpy(np.asarray(array))
        return to_tensor(value, stop_gradient=obj.stop_gradient)
    if up.is_bf16(obj):
        value = bf16_tensor(obj)
        return value.float().numpy() if return_numpy else value
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, up) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, up) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` to ``path`` (its directory is made when missing)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, **configs):
    """What ``save`` wrote to ``path`` (or the JAX package's ``save``),
    its tensors as ``Tensor``s on the current place, or as NumPy arrays
    with ``return_numpy=True``."""
    with open(path, "rb") as f:
        obj, up = read_pickle(f.read())
    return _unpack(obj, configs.get("return_numpy", False), up)
