"""Common functionals (counterpart: ``paddle_tpu/nn/functional/common.py``
and ``input.py``): ``linear`` in Paddle's [in, out] weight layout and
``embedding``, both through the per-op seam (``ops/dispatch.py``) under
the reference's op names."""
from __future__ import annotations

import torch

from ...ops.dispatch import dispatch


def _linear_impl(x, weight, bias):
    y = x @ weight
    return y if bias is None else y + bias


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with weight [in, out]."""
    return dispatch("linear", _linear_impl, x, weight, bias)


def _embedding_impl(weight, x, padding_idx):
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` picked by the ids ``x``; positions holding
    ``padding_idx`` give zeros (so that row gets no gradient)."""
    return dispatch("embedding", _embedding_impl, weight, x,
                    padding_idx=padding_idx)
