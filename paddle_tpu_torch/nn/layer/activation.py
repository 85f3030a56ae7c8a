"""Activation layers (counterpart: ``paddle_tpu/nn/layer/activation.py``):
each calls its functional with the arguments it was built with."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class GELU(nn.Module):
    """Exact erf GELU unless ``approximate`` is set."""

    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)
