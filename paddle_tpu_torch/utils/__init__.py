from . import dlpack, flags

__all__ = ["dlpack", "flags"]
