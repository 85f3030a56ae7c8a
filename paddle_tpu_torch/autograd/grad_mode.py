"""Grad-mode switches: ``paddle.no_grad``, ``enable_grad``,
``set_grad_enabled``, ``is_grad_enabled`` (counterpart:
``paddle_tpu/autograd/grad_mode.py``). They are torch's own: the port's
ops record on PyTorch's tape, which these switch."""
from __future__ import annotations

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()
