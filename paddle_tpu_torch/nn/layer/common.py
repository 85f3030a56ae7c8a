"""Common layers: ``Linear``, ``Embedding``, ``Dropout``, ``Flatten`` and
``Sequential`` (counterpart: ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps Paddle's [in, out] weight layout (``y = x @ W + b``), so
the port's parameters are the JAX package's arrays as they are and
``convert.py`` carries them across without a transpose.

Parameters are drawn when a layer is built, on the CPU from
``generator`` (PyTorch's default generator when none is given), then
moved to the layer's device, so one seed gives the same weights on the
card and on the CPU. The initializers are the reference's defaults:
Xavier-uniform weights, zero biases; an embedding built with
``init_std`` draws normal(0, init_std), as a ``ParamAttr`` with a
``Normal`` initializer does there. ``device`` follows the port's rule:
"cuda" unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch import nn

from ... import resolve_device
from .. import functional as F
from .layers import Layer


def generator_from(seed):
    """A CPU ``torch.Generator``: ``seed`` itself when it is one, else a
    new one seeded with it. Models take either, so a head can hand the
    generator it drew its own layers from on to the model it wraps."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def _param(values, device, dtype):
    return nn.Parameter(values.to(device=resolve_device(device),
                                  dtype=dtype or torch.float32))


def _xavier_uniform(shape, generator):
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


class Linear(Layer):
    """``y = x @ weight + bias`` with weight [in, out] (Paddle's layout)."""

    def __init__(self, in_features, out_features, bias=True, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param(_xavier_uniform((in_features, out_features),
                                             generator), device, dtype)
        self.bias = _param(torch.zeros(out_features), device, dtype) \
            if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    """Rows of ``weight`` [num_embeddings, embedding_dim] picked by id. A
    ``padding_idx`` row starts at zero, and positions holding that id
    give zeros (so the row gets no gradient), as in the reference."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 device=None, dtype=None, generator=None, init_std=None):
        super().__init__()
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self._padding_idx = padding_idx
        shape = (num_embeddings, embedding_dim)
        if init_std is None:
            values = _xavier_uniform(shape, generator)
        else:
            values = torch.empty(shape).normal_(0.0, init_std,
                                                generator=generator)
        if padding_idx is not None:
            values[padding_idx] = 0.0
        self.weight = _param(values, device, dtype)

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)


class Dropout(Layer):
    """Zero each entry with probability ``p`` in training. Mode
    "upscale_in_train" scales the kept entries by 1 / (1 - p);
    "downscale_in_infer" keeps them as they are in training and scales by
    1 - p in eval. ``axis`` draws one keep decision per index along those
    axes, shared across the others."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        if mode not in ("upscale_in_train", "downscale_in_infer"):
            raise ValueError(f"dropout mode {mode!r}")
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        if not self.training or self.p == 0.0:
            if self.mode == "downscale_in_infer" and not self.training:
                return x * (1.0 - self.p)
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        shape = list(x.shape)
        if self.axis is not None:
            axes = [self.axis] if isinstance(self.axis, int) \
                else list(self.axis)
            axes = [a % x.ndim for a in axes]
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = torch.rand(shape, device=x.device) >= self.p
        if self.mode == "upscale_in_train":
            return x * keep / (1.0 - self.p)
        return x * keep


class Flatten(Layer):
    """Axes ``start_axis`` to ``stop_axis`` merged into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Sequential(Layer, nn.Sequential):
    """Layers applied in order. Given as layers, a child is named by its
    position ("0", "1", ...); given as (name, layer) pairs, or as one list
    of them, by its name: the reference's state names either way."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            layers = layers[0]
        nn.Sequential.__init__(self, OrderedDict(
            layer if isinstance(layer, tuple) else (str(i), layer)
            for i, layer in enumerate(layers)))
