"""The high-level training API (counterpart: ``paddle_tpu/hapi``):
``Model`` and its callbacks."""
from . import callbacks
from .model import Model

__all__ = ["Model", "callbacks"]
