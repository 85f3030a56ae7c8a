"""The functional autograd API: ``paddle.grad``, ``vjp``, ``jvp``,
``jacobian``, ``hessian`` (counterpart:
``paddle_tpu/autograd/functional.py``).

``grad`` is ``torch.autograd.grad`` with the reference's argument names
and conventions: it returns one gradient per input and leaves every
``.grad`` untouched; an input the outputs do not reach gets zeros unless
``allow_unused``, which gives None; ``no_grad_vars`` are held constant;
``retain_graph`` defaults to ``create_graph``; outputs that need no
gradient raise. An integer or bool input has no gradient (the
reference's float0): None. ``vjp``, ``jvp``,
``jacobian`` and ``hessian`` are ``torch.autograd.functional``'s over a
function of paddle Tensors; ``vjp`` given no ``v`` takes ones, as the
reference does.
"""
from __future__ import annotations

import torch

from ..ops.dispatch import unwrap, wrap
from ..tensor import Tensor, _grad_capable


def _as_list(x):
    return [x] if isinstance(x, (Tensor, torch.Tensor)) else list(x)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None, name=None):
    """paddle.grad: gradients of ``outputs`` w.r.t. ``inputs``."""
    outs = [unwrap(o) for o in _as_list(outputs)]
    ins = [unwrap(i) for i in _as_list(inputs)]
    if grad_outputs is None:
        cots = [None] * len(outs)
    else:
        cots = [None if g is None else unwrap(g, device=o.device)
                for g, o in zip(_as_list(grad_outputs), outs)]
    cots = [torch.ones_like(o) if g is None else g.to(o.dtype)
            for g, o in zip(cots, outs)]
    if retain_graph is None:
        retain_graph = create_graph
    frozen = [unwrap(v) for v in _as_list(no_grad_vars or [])]
    diff = [i for i, v in enumerate(ins)
            if _grad_capable(v) and v.requires_grad
            and not any(v is f for f in frozen)]
    live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    if not live:
        raise RuntimeError(
            "grad() of outputs with stop_gradient=True and no grad graph")
    got = [None] * len(ins)
    if diff and live:
        gs = _grad_with_frozen(
            [o for o, _ in live], [ins[i] for i in diff], [c for _, c in live],
            bool(retain_graph), bool(create_graph), frozen)
        for i, g in zip(diff, gs):
            got[i] = g
    results = []
    for v, g in zip(ins, got):
        if g is None and not allow_unused and _grad_capable(v):
            g = torch.zeros_like(v)
        results.append(None if g is None else Tensor._wrap(g))
    return results


def _grad_with_frozen(outs, ins, cots, retain_graph, create_graph, frozen):
    """torch.autograd.grad where the ``frozen`` tensors' contributions are
    cut: a hook zeroes the gradient flowing through each of them."""
    handles = [f.register_hook(torch.zeros_like) for f in frozen
               if f.requires_grad]
    try:
        return torch.autograd.grad(outs, ins, cots,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    finally:
        for h in handles:
            h.remove()


def _torch_fn(func):
    def fn(*vals):
        out = func(*[Tensor._wrap(v) for v in vals])
        if isinstance(out, (tuple, list)):
            return tuple(unwrap(o) for o in out)
        return unwrap(out)
    return fn


def _values(xs):
    return tuple(unwrap(x) for x in _as_list(xs))


def _single(xs):
    return isinstance(xs, (Tensor, torch.Tensor))


def vjp(func, xs, v=None):
    """(func(xs), v^T J) over the function's outputs."""
    fn, vals = _torch_fn(func), _values(xs)
    if v is None:
        with torch.no_grad():
            probe = fn(*vals)
        v = tuple(torch.ones_like(o) for o in probe) \
            if isinstance(probe, tuple) else torch.ones_like(probe)
    else:
        v = unwrap(v) if _single(v) else _values(v)
    out, g = torch.autograd.functional.vjp(fn, vals, v)
    g = wrap(g)
    return wrap(out), (g[0] if _single(xs) else list(g))


def jvp(func, xs, v=None):
    """(func(xs), J v); ``v`` defaults to ones."""
    vals = _values(xs)
    tangents = tuple(torch.ones_like(x) for x in vals) if v is None \
        else _values(v)
    out, t = torch.autograd.functional.jvp(_torch_fn(func), vals, tangents)
    return wrap(out), wrap(t)


def jacobian(func, xs, create_graph=False, allow_unused=False,
             batch_axis=None):
    vals = _values(xs)
    j = torch.autograd.functional.jacobian(_torch_fn(func), vals,
                                           create_graph=create_graph)
    j = j[0] if isinstance(j, tuple) and _single(xs) else j
    return wrap(j) if _single(xs) else tuple(wrap(x) for x in j)


def hessian(func, xs, create_graph=False, allow_unused=False,
            batch_axis=None):
    vals = _values(xs)
    h = torch.autograd.functional.hessian(_torch_fn(func), vals,
                                          create_graph=create_graph)
    if _single(xs):
        return wrap(h[0][0] if isinstance(h, tuple) else h)
    return wrap(h)
