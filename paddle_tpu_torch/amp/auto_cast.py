"""Automatic mixed precision: ``auto_cast`` (upstream
``python/paddle/amp/auto_cast.py``).

Counterpart: ``paddle_tpu/amp/auto_cast.py``, copied in torch dtypes: the
thread-local state, ``WHITE_LIST``/``BLACK_LIST``, ``auto_cast`` (alias
``amp_guard``), ``is_auto_cast_enabled``, ``get_amp_dtype`` and
``maybe_cast_inputs``, which the per-op seam (``ops/dispatch.py``) applies
to every op routed through it.

The reference's O1 is not upstream Paddle's: its white list holds
``matmul`` but not ``linear``, so under O1 only explicit matmuls (a GPT's
tied LM head) run in the low dtype, and every projection and attention
stays fp32 (ROADMAP C). The port follows the reference. O2 ("pure") casts
every routed op's floating inputs to the low dtype except the black
list's (``layer_norm``, ``cross_entropy``, ...), which run in fp32.

A cast is ``Tensor.to``, so it is on the autograd graph and gradients
flow back through it in the input's dtype. float64 inputs are never
cast.
"""
from __future__ import annotations

import threading

import torch

_tls = threading.local()

# O1 lists, the reference's: matmul-like ops run in the low dtype,
# numerically sensitive ones in fp32
WHITE_LIST = {
    "matmul", "mv", "mm", "einsum", "conv2d", "conv1d", "conv3d",
    "conv2d_transpose", "addmm", "bmm", "dot",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp",
    "softmax_cross_entropy", "cross_entropy", "softmax_with_cross_entropy",
    "mean", "sum", "norm", "cos_sim", "layer_norm", "batch_norm", "rsqrt",
    "pow", "square", "reciprocal", "erf", "erfinv",
}

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def to_torch_dtype(dtype):
    """A torch dtype from a name ("float16", "bfloat16", "float32") or a
    torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype must be float16 or bfloat16, got "
                         f"{dtype!r}")
    return _DTYPES[dtype]


def _state():
    if not hasattr(_tls, "enabled"):
        _tls.enabled = False
        _tls.dtype = None
        _tls.level = "O1"
        _tls.custom_white = set()
        _tls.custom_black = set()
    return _tls


class auto_cast:
    """``with paddle.amp.auto_cast(enable=True, level='O1',
    dtype='bfloat16')``"""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"level must be O0/O1/O2, got {level}")
        self.enable = bool(enable) and level != "O0"
        self.level = level
        self.dtype = to_torch_dtype(dtype)
        self.white = set(custom_white_list or ())
        self.black = set(custom_black_list or ())

    def __enter__(self):
        st = _state()
        self._prev = (st.enabled, st.dtype, st.level, st.custom_white,
                      st.custom_black)
        st.enabled = self.enable
        st.dtype = self.dtype
        st.level = self.level
        st.custom_white = self.white
        st.custom_black = self.black
        return self

    def __exit__(self, *exc):
        st = _state()
        (st.enabled, st.dtype, st.level, st.custom_white,
         st.custom_black) = self._prev
        return False


amp_guard = auto_cast  # legacy alias


def is_auto_cast_enabled():
    return _state().enabled


def get_amp_dtype():
    """The ambient amp dtype's name: "float16" or "bfloat16" inside an
    enabled ``auto_cast`` block, "float32" outside one."""
    st = _state()
    return str(st.dtype).replace("torch.", "") if st.enabled else "float32"


def maybe_cast_inputs(op_name, tensor_args):
    """``tensor_args`` with their floating tensors cast to the op's amp
    dtype, or unchanged when amp is off or the op follows its inputs (O1
    gray ops)."""
    st = _state()
    if not st.enabled:
        return tensor_args
    low = st.dtype
    white = (WHITE_LIST | st.custom_white) - st.custom_black
    black = (BLACK_LIST | st.custom_black) - st.custom_white
    if st.level == "O2":
        # pure mode: everything in the low dtype except the black list
        target = torch.float32 if op_name in black else low
    elif op_name in white:
        target = low
    elif op_name in black:
        target = torch.float32
    else:
        return tensor_args   # O1 gray: follow the inputs
    return tuple(a.to(target) if isinstance(a, torch.Tensor)
                 and a.is_floating_point() and a.dtype != torch.float64
                 and a.dtype != target else a
                 for a in tensor_args)
