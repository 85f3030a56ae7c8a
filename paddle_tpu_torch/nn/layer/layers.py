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
- ``state_dict`` lists parameters, then persistable buffers, as the
  reference does; ``set_state_dict`` (``set_dict``, ``load_dict``)
  writes into them in place, never swapping a parameter: optimizers key
  their state by the parameter's identity and a ``CompiledTrainStep``
  holds the parameters it was built with.
"""
from __future__ import annotations

import collections

import torch
from torch import nn

from ...framework import dtype as dtype_mod
from ...ops.dispatch import unwrap
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

    # -- state dict ----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=False):
        """The reference's order: every parameter (a tied one once), then
        every persistable buffer, each under its structured name, as
        detached tensors that share the live ones' storage. Called the
        way ``torch.nn.Module`` calls its children (``prefix``,
        ``keep_vars``), it is torch's ``state_dict``."""
        if prefix is not None or keep_vars:
            return super().state_dict(destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=keep_vars)
        dest = destination if destination is not None else \
            collections.OrderedDict()
        pre = structured_name_prefix
        for name, p in self.named_parameters(recurse=include_sublayers):
            dest[pre + name] = p.detach()
            if hasattr(p, "_placement"):    # a rank's piece (TP, ZeRO)
                dest[pre + name]._placement = p._placement
        modules = dict(self.named_modules())
        for name, b in self.named_buffers(recurse=include_sublayers):
            owner, _, short = name.rpartition(".")
            if short not in modules[owner]._non_persistent_buffers_set:
                dest[pre + name] = b.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (paddle ``Tensor``s, torch
        tensors, NumPy arrays) into this layer's parameters and buffers in
        place, each keeping its own dtype and device, so that optimizers
        and train steps holding them see the new values. Returns
        (missing, unexpected) keys; a shape mismatch raises ValueError."""
        own = self.state_dict()
        matched, unexpected = set(), []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                src = unwrap(v, device=torch.device("cpu"))
                dst = own[k]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"shape mismatch for {k}: {tuple(src.shape)} vs "
                        f"{tuple(dst.shape)}")
                dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
                matched.add(k)
        return [k for k in own if k not in matched], unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

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
