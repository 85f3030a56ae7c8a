"""The high-level training API (counterpart: ``paddle_tpu/hapi``):
``Model``, its callbacks, ``summary`` and ``flops``."""
from . import callbacks
from .flops import flops
from .model import Model
from .summary import summary

__all__ = ["Model", "callbacks", "summary", "flops"]
