"""paddle.utils.dlpack of the port (counterpart:
``paddle_tpu/utils/dlpack.py``): tensors exchanged with other frameworks
through DLPack, over ``torch.utils.dlpack``, without a copy where the
producer allows one."""
from __future__ import annotations

import torch.utils.dlpack

from ..tensor import Tensor

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(x):
    """A paddle ``Tensor`` as a DLPack capsule over its memory."""
    if not isinstance(x, Tensor):
        raise TypeError(f"to_dlpack expects a paddle Tensor, got {type(x)}")
    return x._value.detach().__dlpack__()


class _CapsuleWrapper:
    """A raw "dltensor" capsule behind the ``__dlpack__`` protocol. A
    capsule carries no device tag of its own that the protocol reads
    first, so it counts as host memory (kDLCPU), as in the reference."""

    def __init__(self, capsule):
        self._capsule = capsule

    def __dlpack__(self, **kwargs):
        return self._capsule

    def __dlpack_device__(self):
        return (1, 0)   # (kDLCPU, 0)


def from_dlpack(dlpack):
    """A paddle ``Tensor`` over a DLPack capsule or any object with
    ``__dlpack__`` (a torch tensor, a NumPy array...)."""
    if not hasattr(dlpack, "__dlpack__"):
        dlpack = _CapsuleWrapper(dlpack)
    return Tensor._wrap(torch.utils.dlpack.from_dlpack(dlpack))
