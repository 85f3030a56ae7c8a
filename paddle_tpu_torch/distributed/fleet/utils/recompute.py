"""Recompute / activation checkpointing (counterpart: ``paddle_tpu/
distributed/fleet/utils/recompute.py``; upstream ``fleet/utils/
recompute.py``).

``recompute(function, *args, preserve_rng_state=True,
use_reentrant=True)`` runs ``function`` under
``torch.utils.checkpoint.checkpoint``: its activations are not kept, and
the backward runs it again. With ``preserve_rng_state`` the rerun draws
what the forward drew: PyTorch's generators (dropout) through the
checkpoint, the port's own (``framework/random.py``, the random ops)
here, so a dropout inside a recomputed block draws the same mask twice.
paddle ``Tensor`` arguments are passed through as their torch values and
the outputs wrapped back. As in the reference, a call with no argument
that needs a gradient (or with gradients off) just runs ``function``.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint as _ckpt


def _port_states():
    from ..meta_parallel.random import _devices
    from ....framework import random as _random
    return {str(d): _random.generator(d).get_state() for d in _devices()}


def _set_port_states(states):
    from ..meta_parallel.random import _devices
    from ....framework import random as _random
    for d in _devices():
        if str(d) in states:
            _random.generator(d).set_state(states[str(d)])


def recompute(function, *args, **kwargs):
    use_reentrant = kwargs.pop("use_reentrant", True)
    preserve = kwargs.pop("preserve_rng_state", True)
    from ....tensor import Tensor
    surface = any(isinstance(a, Tensor) for a in args)
    raw = [a._value if isinstance(a, Tensor) else a for a in args]
    needs = torch.is_grad_enabled() and any(
        torch.is_tensor(a) and a.requires_grad for a in raw)
    if not needs:
        return function(*args, **kwargs)
    saved = _port_states() if preserve else None
    calls = [0]

    def run(*vals):
        vals = [Tensor._wrap(v) if isinstance(a, Tensor) else v
                for a, v in zip(args, vals)]
        calls[0] += 1
        if calls[0] == 1 or saved is None:
            return _unwrap(function(*vals, **kwargs))
        outer = _port_states()
        _set_port_states(saved)
        try:
            return _unwrap(function(*vals, **kwargs))
        finally:
            _set_port_states(outer)

    out = _ckpt.checkpoint(run, *raw, use_reentrant=use_reentrant,
                           preserve_rng_state=preserve)
    return _wrap(out) if surface else out


def _unwrap(out):
    if isinstance(out, (tuple, list)):
        return type(out)(_unwrap(o) for o in out)
    return getattr(out, "_value", out)


def _wrap(out):
    from ....tensor import Tensor
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) for o in out)
    return Tensor._wrap(out) if torch.is_tensor(out) else out
