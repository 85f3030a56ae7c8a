"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port grows slice by slice beside the JAX package, which stays the
reference it is held against. It imports ``torch`` and never ``jax``,
and nothing of ``paddle_tpu``. Module paths follow the JAX package where
that helps a reader find the counterpart (``text/gpt.py``,
``inference/serving/engine.py``, ``nn/functional/attention.py``); the
TPU kernels are rewritten by hand for Hopper under ``csrc/`` and bound
in ``ops/cuda_kernels.py``.

The device rule: entry points default to ``"cuda"``. Without a card they
raise unless the caller passed ``device="cpu"``; nothing slides onto the
CPU on its own. No 64-bit mode exists here: integer indices the kernels
read are int32.
"""
from __future__ import annotations

import torch

from .utils.flags import get_flags, set_flags

__version__ = "0.1.0"


def default_device():
    """``torch.device("cuda")``, or a RuntimeError naming ``device="cpu"``
    when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` when given (a CUDA
    device still needs a card), else ``default_device()``."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda":
        default_device()
    return device


__all__ = ["__version__", "default_device", "resolve_device", "get_flags",
           "set_flags"]
