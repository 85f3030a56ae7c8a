"""Activation functionals (counterpart: ``paddle_tpu/nn/functional/
activation.py``). ``gelu`` is the exact erf form unless ``approximate``
is set, as in the reference; the port's GPT uses the tanh form on its
own (``text/gpt.py``), and the encoders' layers look these functions up
by name (``TransformerEncoderLayer``'s ``activation``)."""
from __future__ import annotations

import torch


def gelu(x, approximate=False, name=None):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    return torch.relu(x)


def tanh(x, name=None):
    return torch.tanh(x)
