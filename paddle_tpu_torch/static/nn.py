"""paddle.static.nn (counterpart: ``paddle_tpu/static/nn.py``; upstream
``python/paddle/static/nn/control_flow.py``): ``cond``, ``while_loop``,
``case`` and ``switch_case``, the explicit forms dy2static lowers to, over
its converters: the cond and while_loop ops when the predicate is traced
(inside ``to_static``), plain Python on concrete values. ``fc``,
``batch_norm`` and ``embedding`` build a layer on the input's device and
apply it, to eager tensors or to static Variables alike.
"""
from __future__ import annotations

import torch

from ..jit.dy2static import (_is_traced, _to_bool, _traced_cond, _unwrap,
                             convert_while)

__all__ = ["cond", "while_loop", "case", "switch_case", "fc", "batch_norm",
           "embedding"]


def _result(out):
    return tuple(out) if isinstance(out, list) else out


def cond(pred, true_fn=None, false_fn=None, name=None):
    """true_fn() or false_fn(); both return one structure. Under trace
    both branches are needed (a None branch means side effects only,
    which a captured cond cannot represent)."""
    if _is_traced(pred):
        if true_fn is None or false_fn is None:
            raise ValueError(
                "static.nn.cond under trace requires BOTH branches: a "
                "None branch implies side-effect-only semantics that a "
                "captured cond cannot represent")
        return _result(_traced_cond(pred, true_fn, false_fn))
    taken = true_fn if _to_bool(pred) else false_fn
    if taken is None:
        return None
    return _result(taken())


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """``body_fn(*vars)`` returns the structure of ``loop_vars``."""
    single = not isinstance(loop_vars, (list, tuple))
    vars_t = (loop_vars,) if single else tuple(loop_vars)

    def body(*vs):
        out = body_fn(*vs)
        return (out,) if single else tuple(out)

    out = convert_while(cond_fn, body, vars_t)
    return out[0] if single else list(out)


def case(pred_fn_pairs, default=None, name=None):
    """The first (pred, fn) whose pred holds wins; a chain of conds."""
    if not pred_fn_pairs:
        raise ValueError("case needs at least one (pred, fn) pair")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if not rest:
        if default is None:
            return cond(pred, fn, fn)
        return cond(pred, fn, lambda: default())
    return cond(pred, fn, lambda: case(rest, default))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch keyed by ``branch_index`` (a dict or a list of fns), or
    ``default`` (the last branch when None); under trace a chain of conds
    on the index."""
    items = sorted(branch_fns.items()) if isinstance(branch_fns, dict) \
        else list(enumerate(branch_fns))
    fns = [f for _, f in items]
    if default is None:
        default = fns[-1]
    if _is_traced(branch_index):
        idx = _unwrap(branch_index).reshape(())

        def chain(j):
            if j == len(items):
                return default()
            return _traced_cond(idx == items[j][0], items[j][1],
                                lambda: chain(j + 1))

        return _result(chain(0))
    k = int(_unwrap(branch_index))
    return _result(dict(items).get(k, default)())


# -- layer helpers (upstream paddle.static.nn fc/batch_norm/embedding build
#    program ops; here they build the layer and apply it) --

def _device(x):
    return _unwrap(x).device


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    from .. import nn
    from ..nn import functional as F
    shape = list(_unwrap(x).shape)
    in_dim = 1
    for d in shape[num_flatten_dims:]:
        in_dim *= int(d)
    layer = nn.Linear(in_dim, size, bias=bias_attr is not False,
                      device=_device(x))
    flat = x.reshape(shape[:num_flatten_dims] + [in_dim]) \
        if len(shape) > num_flatten_dims + 1 else x
    out = layer(flat)
    if activation:
        out = getattr(F, activation)(out)
    return out


def batch_norm(input, act=None, epsilon=1e-5, momentum=0.9, name=None,
               data_layout="NCHW", **kw):
    from .. import nn
    shape = list(_unwrap(input).shape)
    channels = shape[1] if data_layout == "NCHW" else shape[-1]
    bn = nn.BatchNorm(channels, act=act, epsilon=epsilon, momentum=momentum,
                      data_layout=data_layout, device=_device(input))
    return bn(input)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    from .. import nn
    emb = nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                       device=_device(input))
    return emb(input)
