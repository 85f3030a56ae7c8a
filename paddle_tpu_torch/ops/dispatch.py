"""The per-op seam (counterpart: the part of ``paddle_tpu/ops/dispatch.py``
that every eager op passes through before it runs): the amp casts of
``amp.auto_cast.maybe_cast_inputs`` and the ``FLAGS_check_nan_inf`` scan
of the outputs.

The port's functionals that the JAX GPT dispatches (``embedding``,
``layer_norm``, ``rms_norm``, ``linear``, ``matmul``, ``add``,
``scaled_dot_product_attention``, ``gelu``, ``cross_entropy``) call
``dispatch`` with the reference's op names, so an ``auto_cast`` block
casts each op's inputs as the reference does. With amp off and the flag
clear, the seam costs two attribute reads and one call. It carries no
executable cache and no tape: PyTorch's autograd records the op and the
casts (the rest of the reference's dispatch is ROADMAP A5).

``CompiledTrainStep`` runs its forward and backward inside
``op_scan_off()``: its own fused check over (loss, gradients) stands in
for the per-op scan there, as in the reference, whose compiled step is
traced and scans no op.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..amp.auto_cast import _tls as _amp_tls
from ..amp.auto_cast import maybe_cast_inputs
from ..utils import flags as _flags

_scan = threading.local()


def dispatch(op_name, fn, *tensors, **attrs):
    """``fn(*tensors, **attrs)`` with the amp casts applied to
    ``tensors`` first and, when ``FLAGS_check_nan_inf`` is set, every
    floating output scanned after."""
    if getattr(_amp_tls, "enabled", False):
        tensors = maybe_cast_inputs(op_name, tensors)
    out = fn(*tensors, **attrs)
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
