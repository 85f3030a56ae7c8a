"""Static-graph Variables and the Executor (counterpart:
``paddle_tpu/static/executor.py``; upstream Program/Executor).

The reference records a lazy node at its op dispatch chokepoint. The
port's layers call torch ops directly, so the chokepoint here is torch's
own: a ``Variable`` is a ``torch.Tensor`` subclass over a meta tensor
(shape and dtype, no data) whose ``__torch_function__`` records every
torch call that reads one (functions, Tensor methods and operators,
``torch.library`` ops such as ``paddle_tpu_torch::flash_fwd``, autograd
``Function``s) as a node, and answers with Variables shaped by running
the call on meta tensors. A ``None`` or -1 dimension of ``static.data``
is taken as 1 there, as the reference's abstract value takes it.

A Variable reports the device the program will run on (the place current
at ``static.data``), so tensors a layer makes from ``x.device`` and
Python numbers (positions, masks) are made there at once: they are
constants of the program, as concrete arrays are in the reference. Host
reads (``bool``, ``item``, ``numpy``, ...) and in-place writes on a
Variable raise.

``Executor.run(feed, fetch_list)`` orders the nodes the fetches need
once per feed signature (``exe._cache``) and runs them on the fed
tensors, reading parameters and other tensors live, so updates between
runs are seen: the counterpart of the reference's ``jax.jit`` of the
fetched subgraph. On CUDA feeds the K2 node launches the kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..framework import dtype as dtype_mod

_HOST_READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
               torch.Tensor.__bool__, torch.Tensor.__int__,
               torch.Tensor.__float__, torch.Tensor.__index__,
               torch.Tensor.__array__, torch.Tensor.data_ptr,
               torch.Tensor.__setitem__}
_DEVICE_GET = torch.Tensor.device.__get__


class _Node:
    """One recorded call: ``func(*args, **kwargs)``; its Variables index
    the call's flattened outputs."""

    __slots__ = ("func", "args", "kwargs")

    def __init__(self, func, args, kwargs):
        self.func, self.args, self.kwargs = func, args, kwargs


def _is_var(x):
    return isinstance(x, Variable)


def is_static_var(x):
    return getattr(x, "_is_static_var", False)


def _meta_arg(x):
    if _is_var(x):
        return x
    if isinstance(x, torch.device):
        return torch.device("meta")
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    return x


class Variable(torch.Tensor):
    """A lazy static-graph value: a feed placeholder (``static.data``) or
    a recorded call's output (module doc)."""

    _is_static_var = True

    @staticmethod
    def __new__(cls, meta, device, name=None, node=None, index=0):
        v = torch.Tensor._make_subclass(cls, meta)
        v._device = torch.device(device)
        v._var_name = name
        v._node = node
        v._index = index
        return v

    @property
    def name(self):
        return self._var_name

    @property
    def stop_gradient(self):
        return True

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func == _DEVICE_GET:    # a fresh method-wrapper at each access
            return args[0]._device
        if func in _HOST_READS:
            raise RuntimeError(
                f"static Variable has no value before Executor.run: "
                f"{getattr(func, '__name__', func)} reads it on the host")
        fname = getattr(func, "__name__", "")
        if fname.endswith("_") and not fname.startswith("__") or \
                fname in ("__iadd__", "__isub__", "__imul__",
                          "__itruediv__"):
            raise RuntimeError(f"in-place {fname} on a static Variable is "
                               "not supported")
        margs, mkwargs = pytree.tree_map(_meta_arg, (args, kwargs))
        if "device" in mkwargs:
            mkwargs["device"] = torch.device("meta")
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*margs, **mkwargs)
        leaves, spec = pytree.tree_flatten(out)
        if not any(isinstance(v, torch.Tensor) for v in leaves):
            return out
        device = _out_device(args, kwargs)
        node = _Node(func, args, kwargs)
        return pytree.tree_unflatten(
            [Variable(v.detach(), device, node=node, index=i)
             if isinstance(v, torch.Tensor) else v
             for i, v in enumerate(leaves)], spec)

    def __repr__(self):
        kind = "data" if self._node is None else "op"
        with torch._C.DisableTorchFunctionSubclass():
            shape, dtype = list(self.shape), self.dtype
        return (f"Variable({self._var_name or ''}, {kind}, shape={shape}, "
                f"dtype={str(dtype).replace('torch.', '')})")


def _out_device(args, kwargs):
    dev = kwargs.get("device")
    if dev is not None:
        return torch.device(dev)
    for a in pytree.tree_leaves((args, kwargs)):
        if isinstance(a, torch.device):
            return a
    for a in pytree.tree_leaves((args, kwargs)):
        if _is_var(a):
            return a._device
    return torch.device("cpu")


def data(name, shape, dtype="float32", lod_level=0, device=None):
    """A feed placeholder on ``device`` (the current place's when None)."""
    from ..framework.place import current_device
    shp = [1 if s is None or s == -1 else int(s) for s in shape]
    meta = torch.empty(shp, dtype=dtype_mod.to_torch_dtype(dtype),
                       device="meta")
    return Variable(meta, device if device is not None else
                    current_device(), name=name)


def _args_of(node):
    if isinstance(node.func, _GradImpl):
        return node.func.targets
    return pytree.tree_leaves((node.args, node.kwargs))


def _walk(fetches):
    """(placeholders, nodes in evaluation order) behind the fetches."""
    feeds, order, seen = [], [], set()
    for f in fetches:
        if not _is_var(f):
            continue
        stack = [(f, False)]
        while stack:
            v, done = stack.pop()
            node = v._node
            if node is None:
                if id(v) not in seen:
                    seen.add(id(v))
                    feeds.append(v)
            elif done:
                order.append(node)
            elif id(node) not in seen:
                seen.add(id(node))
                stack.append((v, True))
                stack.extend((a, False) for a in reversed(_args_of(node))
                             if _is_var(a))
    return feeds, order


def _run_nodes(nodes, env):
    """Evaluate ``nodes`` in order; ``env`` maps placeholders (by id) to
    values and receives each node's flat outputs (by the node's id)."""
    def val(a):
        if _is_var(a):
            if a._node is None:
                return env[id(a)]
            return env[id(a._node)][a._index]
        return a

    for node in nodes:
        if isinstance(node.func, _GradImpl):
            env[id(node)] = [node.func.evaluate(env)]
            continue
        args, kwargs = pytree.tree_map(val, (node.args, node.kwargs))
        env[id(node)] = pytree.tree_leaves(node.func(*args, **kwargs))
    return val


class Executor:
    """paddle.static.Executor over Variables: ``run`` evaluates the
    fetched subgraph, its node order cached per feed signature."""

    def __init__(self, place=None):
        self.place = place
        self._cache = {}

    def run(self, program=None, feed=None, fetch_list=None, **kwargs):
        # a startup program (no fetches): parameters are concrete already
        if not fetch_list:
            return []
        feed = feed or {}
        fetches = list(fetch_list)
        for f in fetches:
            if not isinstance(f, torch.Tensor) and not hasattr(f, "_value"):
                raise TypeError(f"fetch_list items must be Variables; "
                                f"got {type(f)}")
        feeds, _ = _walk(fetches)
        vals = []
        for p in feeds:
            if p.name not in feed:
                raise KeyError(f"missing feed '{p.name}'")
            v = feed[p.name]
            v = getattr(v, "_value", v)
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            with torch._C.DisableTorchFunctionSubclass():
                dtype = p.dtype
            vals.append(v.to(device=p._device, dtype=dtype))
        key = (tuple(id(f) for f in fetches), tuple(id(p) for p in feeds),
               tuple((tuple(v.shape), v.dtype) for v in vals))
        plan = self._cache.get(key)
        if plan is None:
            plan = self._cache[key] = _walk(fetches)[1]
        env = {id(p): v for p, v in zip(feeds, vals)}
        with torch.no_grad():
            val = _run_nodes(plan, env)
            outs = [val(f) if _is_var(f) else getattr(f, "_value", f)
                    for f in fetches]
        return [_host(o) for o in outs]

    def close(self):
        self._cache.clear()


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def gradients(targets, inputs, target_gradients=None):
    """paddle.static.gradients: grad Variables of sum(targets) (or
    sum(targets * target_gradients)) with respect to feed placeholders,
    computed by autograd over the targets' subgraph when fetched."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None and \
            not isinstance(target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    out = []
    for i in inputs:
        impl = _GradImpl(targets, i, target_gradients)
        with torch._C.DisableTorchFunctionSubclass():
            meta = torch.empty_like(i)
        out.append(Variable(meta, i._device, name=f"grad({i.name})",
                            node=_Node(impl, (), {})))
    return out


class _GradImpl:
    """A gradient Variable's node: differentiates the targets' subgraph
    with respect to one placeholder."""

    def __init__(self, targets, wrt, target_gradients=None):
        self.targets = targets
        self.wrt = wrt
        self.target_gradients = target_gradients
        self.feeds, self.nodes = _walk(targets)
        if not any(p is wrt for p in self.feeds):
            raise ValueError(
                f"input '{wrt.name}' is not reachable from the targets")

    def evaluate(self, feed_env):
        # from the placeholders only: the caller's computed values were
        # made without a graph
        env = {id(p): feed_env[id(p)] for p in self.feeds}
        x = env[id(self.wrt)].detach().requires_grad_(True)
        env[id(self.wrt)] = x
        tg = self.target_gradients
        with torch.enable_grad():
            val = _run_nodes(self.nodes, env)
            total = 0.0
            for i, t in enumerate(self.targets):
                tv = val(t)
                if tg is not None and tg[i] is not None:
                    w = getattr(tg[i], "_value", tg[i])
                    total = total + (tv * torch.as_tensor(
                        w, device=tv.device)).sum()
                else:
                    total = total + tv.sum()
            (g,) = torch.autograd.grad(total, x, allow_unused=True)
        return torch.zeros_like(x) if g is None else g.detach()
