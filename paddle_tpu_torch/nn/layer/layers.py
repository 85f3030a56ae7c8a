"""``paddle.nn.Layer`` of the port (counterpart:
``paddle_tpu/nn/layer/layers.py``): a ``torch.nn.Module``, the base of
the port's layers and models, and the boundary between the ``paddle.*``
surface and their torch-native insides.

- A built-in layer (one defined in this package) called with a paddle
  ``Tensor`` among its inputs unwraps those inputs and wraps its tensor
  outputs; called with torch tensors it runs exactly as a Module does.
- A user's own ``Layer`` subclass gets its inputs as given, so paddle
  ops and Tensor methods work inside its ``forward``.
- Parameters stay ``torch.nn.Parameter``s, which the port's optimizers
  update and ``paddle.grad`` and the ops accept.
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework import dtype as dtype_mod
from ...tensor import Tensor

_PACKAGE = __name__.split(".")[0] + "."


def _unwrap_tree(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap_tree(v) for v in x)
    return x


def _wrap_tree(x):
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: _wrap_tree(v) for k, v in x.items()}
    return x


def _has_surface_tensor(args, kwargs):
    for a in args:
        if isinstance(a, Tensor):
            return True
    for a in kwargs.values():
        if isinstance(a, Tensor):
            return True
    return False


class Layer(nn.Module):
    _surface_boundary = False

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._surface_boundary = cls.__module__.startswith(_PACKAGE)

    def __call__(self, *args, **kwargs):
        if self._surface_boundary and _has_surface_tensor(args, kwargs):
            args = _unwrap_tree(args)
            kwargs = {k: _unwrap_tree(v) for k, v in kwargs.items()}
            return _wrap_tree(super().__call__(*args, **kwargs))
        return super().__call__(*args, **kwargs)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A ``torch.nn.Parameter`` on the current place: zeros for a
        bias, Xavier-uniform otherwise (the reference's defaults)."""
        from ...tensor import create_parameter
        p = create_parameter(shape, dtype or dtype_mod.get_default_dtype(),
                             attr=attr, is_bias=is_bias,
                             default_initializer=default_initializer)
        return nn.Parameter(p._value.detach(),
                            requires_grad=not p.stop_gradient)
