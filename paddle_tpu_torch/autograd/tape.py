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
- ``deferred_leaf_grads(pred)``: the zero-bubble pipeline's B/W split.
  Inside the context, ``backward`` walks the graph once with
  ``torch.autograd.grad`` over every leaf it reaches (so nothing is
  accumulated by the engine): a leaf that matches ``pred`` has its
  gradient queued in the order the walk produced it, every other leaf is
  accumulated the moment its gradient is computed (its grad-ready hooks
  fire then). ``flush()`` (the W pass) adds the queued gradients into
  ``.grad`` in walk order and fires their grad-ready hooks; the result is
  bit-identical to a plain ``backward()``, since the engine sums a
  leaf's contributions before handing it over in both. Leaving the
  context does not flush; a context never flushed drops what it queued,
  as ``clear_grad`` before they landed would. Honesty note, as in the
  reference: the split defers the accumulation, not the vjp's compute,
  which the walk does as it reaches each node; what W buys is order (a
  pipeline stage's input gradient leaves before the weights'
  accumulation). Tensor hooks (``register_hook``) run during the walk,
  as they do under a plain backward.
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


_deferred_stack: list = []


class deferred_leaf_grads:
    """Split a ``backward`` into B (the walk; leaves not matching
    ``pred`` accumulate inline) and W (``flush()``: the queued leaves'
    accumulation and grad-ready hooks, in walk order)."""

    def __init__(self, pred):
        self._pred = pred
        self._queue = []

    def __enter__(self):
        _deferred_stack.append(self)
        return self

    def __exit__(self, *exc):
        _deferred_stack.remove(self)
        return False

    def deferred_count(self):
        return len(self._queue)

    def flush(self):
        """Accumulate the queued gradients in walk order and fire their
        grad-ready hooks. Safe to call after the context exited."""
        q, self._queue = self._queue, []
        for leaf, g in q:
            _accumulate(leaf, g)


def _accumulate(leaf, g):
    """Add ``g`` into ``leaf.grad`` as the engine's AccumulateGrad does
    (store it when there is none), then run the leaf's grad-ready hooks."""
    with torch.no_grad():
        if leaf.grad is None:
            leaf.grad = g.detach()
        else:
            leaf.grad += g
    hooks = getattr(leaf, "_post_accumulate_grad_hooks", None) or {}
    for hook in list(hooks.values()):
        hook(leaf)


def _reachable_leaves(roots):
    """The leaves that need a gradient, reachable from ``roots``' graph,
    each once."""
    seen, out, stack = set(), [], [r.grad_fn for r in roots
                                   if r.grad_fn is not None]
    for r in roots:
        if r.grad_fn is None and r.requires_grad:
            out.append(r)
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            out.append(var)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return out


def _deferred_backward(ctx, outs, cots, retain_graph, create_graph):
    """One walk: matching leaves queued on ``ctx`` in walk order, the
    others accumulated as their gradients are computed."""
    leaves = _reachable_leaves(outs)
    if not leaves:
        return
    order, handles = [], []
    for i, leaf in enumerate(leaves):
        if ctx._pred(leaf):
            handles.append(leaf.register_hook(
                lambda g, i=i: order.append(i)))
        else:
            handles.append(leaf.register_hook(
                lambda g, leaf=leaf: _accumulate(leaf, g)))
    try:
        grads = torch.autograd.grad(outs, leaves, cots,
                                    retain_graph=retain_graph,
                                    create_graph=create_graph,
                                    allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    ctx._queue.extend((leaves[i], grads[i]) for i in order
                      if grads[i] is not None)


def backward(tensors, grad_tensors=None, retain_graph=False,
             create_graph=False):
    """paddle.autograd.backward: reverse accumulation from ``tensors``
    into the ``.grad`` of every reachable leaf that needs a gradient
    (``create_graph`` keeps the gradients differentiable). Inside
    ``deferred_leaf_grads`` the matching leaves are queued instead."""
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
    retain = bool(retain_graph) or create_graph
    if _deferred_stack:
        _deferred_backward(_deferred_stack[-1], outs, cots, retain,
                           bool(create_graph))
    else:
        torch.autograd.backward(outs, cots, retain_graph=retain,
                                create_graph=bool(create_graph))
    for fn in list(_post_backward_hooks.values()):
        fn()
