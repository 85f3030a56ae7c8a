"""paddle.Tensor of the port: an eager tensor over a ``torch.Tensor``
(counterpart: ``paddle_tpu/tensor.py``, whose payload is a ``jax.Array``).

``Tensor`` is the port's own class holding the torch tensor in
``_value``, not a subclass of ``torch.Tensor``: Paddle gives its own
meanings to ``shape`` (a list), ``size`` (an int), ``dtype`` (a paddle
``DType``), ``transpose(perm)`` and ``sum(axis=...)``. The op methods
are attached from ``tensor_methods.py``, as the reference does.

Autograd is PyTorch's engine; there is no second tape:

- ``stop_gradient`` is ``not _value.requires_grad`` (settable on a
  leaf; on an integer tensor, which torch cannot mark, it is a stored
  flag, and such a tensor never gets a gradient);
- ``grad`` wraps ``_value.grad`` (None on a non-leaf unless
  ``retain_grads()`` was called), ``grad_node`` is ``_value.grad_fn``,
  ``is_leaf`` is ``_value.is_leaf``;
- ``backward`` and ``register_hook`` are torch's.

"In-place" methods follow the reference, which replaces the payload:
the new value takes the place of the old one in this object, so a leaf
that requires grad may be written (torch refuses an in-place write
there) and a graph that saved the old value stays valid.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework import dtype as dtype_mod
from .framework.place import CPUPlace, CUDAPlace, place_of


def _grad_capable(v):
    return v.is_floating_point() or v.is_complex()


class Tensor:
    __slots__ = ("_value", "_sg", "name", "persistable", "trainable",
                 "__weakref__", "__dict__")

    def __init__(self, value, dtype=None, place=None, stop_gradient=True,
                 name=None):
        from .ops.dispatch import unwrap
        device = None if place is None else place_of(place).torch_device()
        v = unwrap(value, dtype=dtype, device=device)
        if dtype is not None:
            td = dtype_mod.to_torch_dtype(dtype)
            if v.dtype != td:
                v = v.to(td)
        if device is not None and v.device != device:
            v = v.to(device)
        self._value = v
        self._sg = True
        self.name = name
        self.persistable = False
        self.trainable = not stop_gradient
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, value):
        """A Tensor over the torch tensor ``value`` as it is (no copy)."""
        t = object.__new__(cls)
        t._value = value
        t._sg = True
        t.name = None
        t.persistable = False
        t.trainable = False
        return t

    # -- metadata ------------------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.ndim

    @property
    def dtype(self):
        return dtype_mod.to_paddle_dtype(self._value.dtype)

    @property
    def size(self):
        return self._value.numel()

    @property
    def place(self):
        dev = self._value.device
        return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)

    @property
    def stop_gradient(self):
        v = self._value
        return not v.requires_grad if _grad_capable(v) else self._sg

    @stop_gradient.setter
    def stop_gradient(self, flag):
        flag = bool(flag)
        v = self._value
        if not _grad_capable(v):
            self._sg = flag
        elif v.is_leaf:
            v.requires_grad_(not flag)
        elif flag:
            # a non-leaf leaves the graph: later ops see a constant
            self._value = v.detach()

    @property
    def grad(self):
        v = self._value
        if not v.is_leaf and not v.retains_grad:
            return None
        g = v.grad
        return None if g is None else Tensor._wrap(g)

    @grad.setter
    def grad(self, g):
        from .ops.dispatch import unwrap
        self._value.grad = None if g is None else unwrap(g)

    @property
    def grad_node(self):
        return self._value.grad_fn

    @property
    def is_leaf(self):
        return self._value.is_leaf

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-D tensor")
        return self._value.shape[0]

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {self.numpy()!r})")

    # -- host interop --------------------------------------------------------
    def numpy(self):
        """A NumPy copy. NumPy has no bfloat16: a bf16 tensor comes back
        as float32 (exact), where the reference returns an ml_dtypes
        bfloat16 array."""
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._value.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __bool__(self):
        return bool(self._value)

    def __int__(self):
        return int(self._value.detach().reshape(()).item())

    def __float__(self):
        return float(self._value.detach().reshape(()).item())

    def __index__(self):
        return int(self._value.detach().reshape(()).item())

    # -- autograd ------------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False,
                 create_graph=False):
        from .autograd.tape import backward as _backward
        _backward([self], [grad_tensor] if grad_tensor is not None else None,
                  retain_graph=retain_graph, create_graph=create_graph)

    def retain_grads(self):
        if self._value.requires_grad and not self._value.is_leaf:
            self._value.retain_grad()

    def register_hook(self, hook):
        """``hook(grad) -> grad | None`` on this tensor's gradient, once
        per backward (torch's ``register_hook``); returns a handle with
        ``.remove()``."""
        from .ops.dispatch import unwrap

        def on_grad(g):
            out = hook(Tensor._wrap(g))
            return None if out is None else unwrap(out)
        return self._value.register_hook(on_grad)

    def clear_grad(self, set_to_zero=False):
        self._value.grad = None

    clear_gradient = clear_grad

    def detach(self):
        t = Tensor._wrap(self._value.detach())
        t.name = self.name
        return t

    def clone(self):
        from .ops.creation import assign
        return assign(self)

    # -- device / dtype movement ---------------------------------------------
    def to(self, *args, **kwargs):
        dtype = kwargs.get("dtype")
        device = kwargs.get("device")
        for a in args:
            if isinstance(a, str) and a not in dtype_mod._BY_NAME:
                device = a
            elif isinstance(a, (torch.device,)) or hasattr(a, "device_type"):
                device = a
            else:
                dtype = a
        v = self._value
        if dtype is not None:
            v = v.to(dtype_mod.to_torch_dtype(dtype))
        if device is not None:
            v = v.to(place_of(device).torch_device())
        return Tensor._wrap(v)

    def cpu(self):
        return Tensor._wrap(self._value.cpu())

    def cuda(self, device_id=0, blocking=True):
        return Tensor._wrap(self._value.to(
            CUDAPlace(device_id or 0).torch_device()))

    def pin_memory(self):
        return self

    def __dlpack__(self, **kwargs):
        return self._value.detach().__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._value.__dlpack_device__()

    # value replacement used by optimizers / load_state_dict ----------------
    def _set_value(self, new):
        """Replace the payload with ``new``'s values: in place (under
        no_grad) when shape and dtype agree, so whatever holds this
        tensor's torch value sees the new one; by replacement otherwise."""
        from .ops.dispatch import unwrap
        nv = unwrap(new, device=self._value.device)
        v = self._value
        if nv.shape == v.shape and nv.dtype == v.dtype:
            with torch.no_grad():
                v.copy_(nv)
        else:
            self._replace(nv.detach().to(v.device))
        return self

    set_value = _set_value

    def _replace(self, new_value):
        """The reference's payload swap: ``new_value`` takes the place of
        the current one. A new leaf needs a gradient when the old value
        did (a leaf's ``.grad`` carries over)."""
        old = self._value
        if (old.requires_grad and new_value.is_leaf
                and _grad_capable(new_value)):
            new_value.requires_grad_(True)
            if old.is_leaf:
                new_value.grad = old.grad
        self._value = new_value
        return self

    def get_tensor(self):
        return self

    def _md5sum(self):
        import hashlib
        return hashlib.md5(self.numpy().tobytes()).hexdigest()


class Parameter(Tensor):
    """A trainable Tensor (stop_gradient=False)."""

    def __init__(self, value, dtype=None, name=None, trainable=True,
                 place=None):
        super().__init__(value, dtype=dtype, place=place,
                         stop_gradient=not trainable, name=name)
        self.persistable = True
        self.trainable = trainable

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def create_parameter(shape, dtype=None, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """paddle.create_parameter: a free-standing trainable Parameter on the
    current place. Its values follow the reference's defaults: zeros for
    a bias, Xavier-uniform (fan in and fan out from the first two
    dimensions) otherwise; ``default_initializer`` (a callable
    ``(shape, dtype) -> array``) and ``attr.initializer`` take
    precedence, and ``attr.trainable=False`` gives a frozen one."""
    from .framework.place import current_device
    from .framework.random import generator
    dtype = dtype_mod.to_paddle_dtype(dtype or dtype_mod.get_default_dtype())
    shape = [int(s) for s in shape]
    init = getattr(attr, "initializer", None) or default_initializer
    device = current_device()
    if init is not None:
        value = init(shape, dtype)
    elif is_bias:
        value = torch.zeros(shape, dtype=dtype.torch_dtype, device=device)
    else:
        fan_in = shape[0] if shape else 1
        fan_out = shape[1] if len(shape) > 1 else shape[0] if shape else 1
        rf = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        limit = float(np.sqrt(6.0 / ((fan_in + fan_out) * rf)))
        value = torch.empty(shape, dtype=torch.float32, device=device)
        value.uniform_(-limit, limit, generator=generator(device))
        value = value.to(dtype.torch_dtype)
    name = name or (getattr(attr, "name", None) if attr is not None
                    else None)
    trainable = getattr(attr, "trainable", True) is not False
    return Parameter(value, dtype=dtype, name=name, trainable=trainable,
                     place=place_of(device))


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new Tensor on ``place`` (the current place when
    None) holding a copy of ``data``: a Tensor, a torch tensor, a NumPy
    array, a Python number or a nested list. Python floats become the
    default float dtype, Python ints int64; arrays keep their dtype."""
    from .framework.place import current_device
    device = place_of(place).torch_device() if place is not None \
        else current_device()
    from .ops.dispatch import unwrap
    v = unwrap(data, dtype=dtype, device=device)
    td = v.dtype if dtype is None else dtype_mod.to_torch_dtype(dtype)
    # a copy: the new tensor shares nothing with ``data``
    v = v.detach().to(device=device, dtype=td,
                      copy=isinstance(data, (Tensor, torch.Tensor)))
    t = Tensor._wrap(v)
    if not stop_gradient:
        t.stop_gradient = False
    t.trainable = not stop_gradient
    return t
