"""``backward`` and the tape's hook seams (counterpart:
``paddle_tpu/autograd/tape.py``) over PyTorch's engine.

- ``backward(tensors, grad_tensors, retain_graph)`` is
  ``torch.autograd.backward`` with the reference's checks and messages:
  a tensor that needs no gradient raises, and so does a non-scalar
  output given no gradient. Gradients add up in ``.grad`` until
  ``clear_grad``; a second backward over a freed graph raises.
- ``register_grad_ready_hook(tensor, fn)`` (the per-leaf seam a bucketed
  data-parallel reducer hangs on) is torch's
  ``register_post_accumulate_grad_hook``: ``fn(tensor)`` runs once per
  backward, the moment the leaf's ``.grad`` holds its final value.
- ``register_post_backward_hook(fn)`` runs ``fn()`` after every
  ``backward`` made through this function.
"""
from __future__ import annotations

import itertools

import torch

_post_backward_hooks: dict[int, object] = {}
_ids = itertools.count()


class _Handle:
    def __init__(self, remove):
        self.remove = remove


def register_post_backward_hook(fn):
    """Run ``fn()`` after each completed ``backward()``; returns a handle
    with ``.remove()``."""
    hid = next(_ids)
    _post_backward_hooks[hid] = fn
    return _Handle(lambda: _post_backward_hooks.pop(hid, None))


def register_grad_ready_hook(tensor, fn):
    """``fn(tensor)`` the moment this leaf's gradient is final within a
    backward (all contributions accumulated, grad hooks applied,
    ``.grad`` written); returns a handle with ``.remove()``."""
    from ..tensor import Tensor
    raw = tensor._value if isinstance(tensor, Tensor) else tensor
    if not raw.is_leaf:
        raise ValueError("register_grad_ready_hook takes a leaf tensor")
    return raw.register_post_accumulate_grad_hook(lambda _: fn(tensor))


def backward(tensors, grad_tensors=None, retain_graph=False,
             create_graph=False):
    """paddle.autograd.backward: reverse accumulation from ``tensors``
    into the ``.grad`` of every reachable leaf that needs a gradient
    (``create_graph`` keeps the gradients differentiable)."""
    from ..ops.dispatch import unwrap
    from ..tensor import Tensor
    if isinstance(tensors, (Tensor, torch.Tensor)):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif isinstance(grad_tensors, (Tensor, torch.Tensor)):
        grad_tensors = [grad_tensors]
    outs, cots = [], []
    for t, g in zip(tensors, grad_tensors):
        v = unwrap(t)
        if not v.requires_grad:
            raise RuntimeError(
                "backward() on a tensor with stop_gradient=True and no "
                "grad graph")
        if g is None:
            if v.numel() != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar "
                    f"outputs; got shape {tuple(v.shape)}")
            g = torch.ones_like(v)
        else:
            g = unwrap(g, device=v.device).to(v.dtype).expand(v.shape)
        outs.append(v)
        cots.append(g)
    torch.autograd.backward(outs, cots,
                            retain_graph=bool(retain_graph) or create_graph,
                            create_graph=bool(create_graph))
    for fn in list(_post_backward_hooks.values()):
        fn()
