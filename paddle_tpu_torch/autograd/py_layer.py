"""PyLayer: a user-defined forward and backward (counterpart:
``paddle_tpu/autograd/py_layer.py``) as a ``torch.autograd.Function``.

``forward(ctx, *args)`` and ``backward(ctx, *grads)`` take and return
paddle Tensors; ``ctx.save_for_backward`` and ``ctx.saved_tensor`` keep
paddle Tensors. ``backward`` returns one gradient per Tensor input, in
order (None for one it does not give), as in the reference.
"""
from __future__ import annotations

import torch

from ..ops.dispatch import unwrap, wrap
from ..tensor import Tensor


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(fctx, cls, ctx, spec, kwargs, *vals):
        args = [Tensor._wrap(v) if s else v for s, v in zip(spec, vals)]
        out = cls.forward(ctx, *args, **kwargs)
        fctx.cls, fctx.ctx, fctx.spec = cls, ctx, spec
        ctx._single = not isinstance(out, (tuple, list))
        outs = (out,) if ctx._single else tuple(out)
        return tuple(unwrap(o) for o in outs)

    @staticmethod
    def backward(fctx, *cots):
        cot = [None if c is None else Tensor._wrap(c) for c in cots]
        gin = fctx.cls.backward(fctx.ctx, *cot)
        if not isinstance(gin, (tuple, list)):
            gin = (gin,)
        gi = iter(gin)
        grads = [(lambda g: None if g is None else unwrap(g))(next(gi, None))
                 if s else None for s in fctx.spec]
        return (None, None, None, None, *grads)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        """``forward`` on the Tensor arguments (keyword arguments pass
        through to it as they are), recorded with ``backward`` as its
        gradient."""
        ctx = PyLayerContext()
        spec = tuple(isinstance(a, (Tensor, torch.Tensor)) for a in args)
        vals = tuple(unwrap(a) if s else a for s, a in zip(spec, args))
        outs = wrap(tuple(_Function.apply(cls, ctx, spec, kwargs, *vals)))
        return outs[0] if ctx._single else outs
