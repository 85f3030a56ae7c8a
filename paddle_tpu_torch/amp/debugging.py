"""``paddle.amp.debugging`` (upstream ``python/paddle/amp/debugging.py``):
numerical-stability debugging helpers.

Counterpart: ``paddle_tpu/amp/debugging.py``. The tensor checker turns
``FLAGS_check_nan_inf`` on and off (``utils/flags.py``), which the per-op
seam (``ops/dispatch.py``) and ``CompiledTrainStep`` read;
``check_numerics`` scans one tensor now.
"""
from __future__ import annotations

import torch

from ..utils import flags as _flags


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class TensorCheckerConfig:
    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


def enable_tensor_checker(checker_config=None):
    """Turn on the per-op nan/inf scan (``FLAGS_check_nan_inf``)."""
    _flags.set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    _flags.set_flags({"FLAGS_check_nan_inf": False})


def check_numerics(tensor, op_type="check_numerics", var_name="tensor",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """Scan one tensor now; raise on nan or inf as the reference's abort
    mode does. Returns the tensor."""
    t = torch.as_tensor(tensor)
    if not (t.is_floating_point() or t.is_complex()):
        return tensor
    if not bool(torch.isfinite(t).all()):
        n_nan = int(torch.isnan(t).sum())
        n_inf = int(torch.isinf(t).sum())
        raise RuntimeError(
            f"check_numerics: {op_type} output '{var_name}' contains "
            f"{n_nan} nan / {n_inf} inf values")
    return tensor
