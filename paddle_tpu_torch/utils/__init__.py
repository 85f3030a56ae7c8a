from . import flags

__all__ = ["flags"]
