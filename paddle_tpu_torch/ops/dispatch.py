"""The per-op seam (counterpart: the part of ``paddle_tpu/ops/dispatch.py``
that every eager op passes through before it runs): the amp casts of
``amp.auto_cast.maybe_cast_inputs`` and the ``FLAGS_check_nan_inf`` scan
of the outputs.

The port's functionals that the JAX GPT dispatches (``embedding``,
``layer_norm``, ``rms_norm``, ``linear``, ``matmul``, ``add``,
``scaled_dot_product_attention``, ``gelu``, ``cross_entropy``) call
``dispatch`` with the reference's op names, so an ``auto_cast`` block
casts each op's inputs as the reference does. With amp off and the flag
clear, the seam costs a type check per input, two attribute reads and
one call. It carries no executable cache and no tape (the reference's
per-op jit cache and GradNodes have no counterpart): PyTorch's autograd
records the op and the casts.

``CompiledTrainStep`` runs its forward and backward inside
``op_scan_off()``: its own fused check over (loss, gradients) stands in
for the per-op scan there, as in the reference, whose compiled step is
traced and scans no op.

The seam also carries the reference's ``unwrap``/``wrap``
(``paddle_tpu/ops/dispatch.py``): an op given a paddle ``Tensor`` among
its inputs unwraps them, applies the amp casts, runs its torch impl,
scans the outputs and wraps them as paddle Tensors. Called with torch
tensors alone, as the models call it, it returns torch tensors and
costs one more type check per input. ``nondiff`` is the same seam for
ops that are never differentiable (comparisons, indices): it runs the
impl under ``torch.no_grad()`` and applies no amp cast.

``set_op_profiler(cb)`` installs the reference's op-profiler hook
(``paddle.profiler.Profiler(serialize=True)`` does, while it records):
each op is then timed on the host clock through a synchronise on its
outputs' devices, and ``cb(op_name, seconds)`` receives it. With no hook
the cost is one module attribute read per op.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..amp.auto_cast import _tls as _amp_tls
from ..amp.auto_cast import maybe_cast_inputs
from ..framework import dtype as dtype_mod
from ..tensor import Tensor
from ..utils import flags as _flags

_scan = threading.local()

# the op-level profiling hook (None: one attribute read per op)
_op_profiler = None


def set_op_profiler(cb):
    """``cb(op_name, seconds)`` or None. While installed, every op that
    passes the seam is timed through a synchronise on its outputs."""
    global _op_profiler
    _op_profiler = cb


def _timed(op_name, fn, tensors, attrs, cb):
    t0 = time.perf_counter()
    out = fn(*tensors, **attrs)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for dev in {o.device for o in outs
                if isinstance(o, torch.Tensor) and o.is_cuda}:
        torch.cuda.synchronize(dev)
    cb(op_name, time.perf_counter() - t0)
    return out


def dispatch(op_name, fn, *tensors, **attrs):
    """``fn(*tensors, **attrs)`` with the amp casts applied to
    ``tensors`` first and, when ``FLAGS_check_nan_inf`` is set, every
    floating output scanned after. With a paddle ``Tensor`` among
    ``tensors`` the inputs are unwrapped first and the outputs wrapped."""
    for t in tensors:
        if isinstance(t, Tensor):
            return _surface(op_name, fn, tensors, attrs, True)
    if getattr(_amp_tls, "enabled", False):
        tensors = maybe_cast_inputs(op_name, tensors)
    out = fn(*tensors, **attrs) if _op_profiler is None else \
        _timed(op_name, fn, tensors, attrs, _op_profiler)
    if _flags.FAST.check_nan_inf and not getattr(_scan, "off", False):
        _check_nan_inf(op_name, out)
    return out


@contextlib.contextmanager
def op_scan_off():
    """No per-op ``FLAGS_check_nan_inf`` scan on this thread inside the
    block."""
    prev = getattr(_scan, "off", False)
    _scan.off = True
    try:
        yield
    finally:
        _scan.off = prev


def _check_nan_inf(op_name, out):
    """Raise at the first op whose output holds nan or inf, with the
    reference's message (one host sync per op: it is a debug mode)."""
    outs = out if isinstance(out, tuple) else (out,)
    for i, o in enumerate(outs):
        if not isinstance(o, torch.Tensor) or not (
                o.is_floating_point() or o.is_complex()):
            continue
        if not bool(torch.isfinite(o).all()):
            n_nan = int(torch.isnan(o).sum())
            n_inf = int(torch.isinf(o).sum())
            raise RuntimeError(
                f"FLAGS_check_nan_inf: op '{op_name}' output {i} "
                f"(shape {tuple(o.shape)}, dtype "
                f"{str(o.dtype).replace('torch.', '')}) contains "
                f"{n_nan} nan / {n_inf} inf values")
    return out


def nondiff(op_name, fn, *tensors, **attrs):
    """``dispatch`` for ops that are never differentiable: ``fn`` runs
    under ``torch.no_grad()`` with no amp cast."""
    for t in tensors:
        if isinstance(t, Tensor):
            return _surface(op_name, fn, tensors, attrs, False)
    with torch.no_grad():
        out = fn(*tensors, **attrs) if _op_profiler is None else \
            _timed(op_name, fn, tensors, attrs, _op_profiler)
    if _flags.FAST.check_nan_inf and not getattr(_scan, "off", False):
        _check_nan_inf(op_name, out)
    return out


def _surface(op_name, fn, tensors, attrs, diff):
    vals = tuple(t._value if isinstance(t, Tensor) else t for t in tensors)
    if diff:
        if getattr(_amp_tls, "enabled", False):
            vals = maybe_cast_inputs(op_name, vals)
        out = fn(*vals, **attrs) if _op_profiler is None else \
            _timed(op_name, fn, vals, attrs, _op_profiler)
    else:
        with torch.no_grad():
            out = fn(*vals, **attrs) if _op_profiler is None else \
                _timed(op_name, fn, vals, attrs, _op_profiler)
    if _flags.FAST.check_nan_inf and not getattr(_scan, "off", False):
        _check_nan_inf(op_name, out)
    return wrap(out)


def wrap(value):
    """Torch tensors (also inside tuples and lists) as paddle Tensors;
    anything else as it is."""
    if isinstance(value, torch.Tensor):
        return Tensor._wrap(value)
    if isinstance(value, tuple):
        return tuple(wrap(v) for v in value)
    if isinstance(value, list):
        return [wrap(v) for v in value]
    return value


def unwrap(x, dtype=None, device=None):
    """Tensor | torch tensor | array-like -> torch tensor.

    The reference's number promotion: Python floats land on the default
    float dtype (float32), Python ints on int64, NumPy arrays keep their
    dtype. A new tensor (from numbers or arrays) is made on ``device``,
    the current place's device when None; ``dtype`` sets its dtype."""
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    if not isinstance(x, (bool, int, float, complex, np.ndarray, np.generic,
                          list, tuple)):
        raise TypeError(f"cannot convert {type(x)} to a tensor")
    if device is None:
        from ..framework.place import current_device
        device = current_device()
    from_np = isinstance(x, (np.ndarray, np.generic))
    arr = np.asarray(x)
    if arr.dtype == object:
        raise TypeError(f"cannot convert {type(x)} to a tensor")
    if dtype is not None:
        td = dtype_mod.to_torch_dtype(dtype)
    elif arr.dtype == np.float64 and not from_np:
        td = dtype_mod.default_float().torch_dtype
    else:
        td = None
    v = torch.tensor(arr)
    return v.to(device=device, dtype=td or v.dtype)
