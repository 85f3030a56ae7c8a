"""Vision models (counterpart: ``paddle_tpu/vision``)."""
from . import models

__all__ = ["models"]
