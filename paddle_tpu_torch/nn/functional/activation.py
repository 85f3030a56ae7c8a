"""Activation functionals (counterpart: ``paddle_tpu/nn/functional/
activation.py``). ``gelu`` is the exact erf form unless ``approximate``
is set, as in the reference (the GPT takes the tanh form), and goes
through the per-op seam (``ops/dispatch.py``) as op "gelu"; the encoders'
layers look these functions up by name (``TransformerEncoderLayer``'s
``activation``)."""
from __future__ import annotations

import torch

from ...ops.dispatch import dispatch


def _gelu_impl(x, approximate):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    return dispatch("gelu", _gelu_impl, x, approximate=bool(approximate))


def relu(x, name=None):
    return torch.relu(x)


def tanh(x, name=None):
    return torch.tanh(x)
