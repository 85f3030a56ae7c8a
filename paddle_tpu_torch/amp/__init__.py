"""Mixed precision (counterpart: ``paddle_tpu/amp``): ``auto_cast``,
``decorate``, ``GradScaler`` and ``debugging``."""
from . import debugging
from .auto_cast import (amp_guard, auto_cast, get_amp_dtype,
                        is_auto_cast_enabled)
from .decorate import decorate
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "GradScaler", "AmpScaler", "decorate",
           "is_auto_cast_enabled", "get_amp_dtype", "debugging"]
