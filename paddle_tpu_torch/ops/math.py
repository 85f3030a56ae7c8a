"""Element-wise and matrix ops the models route through the per-op seam
(counterpart: ``paddle_tpu/ops/math.py`` ``add`` and
``paddle_tpu/ops/linalg.py`` ``matmul``), under the reference's op
names, so an ``auto_cast`` block casts their inputs as it does there."""
from __future__ import annotations

import torch

from .dispatch import dispatch


def add(x, y, name=None):
    return dispatch("add", torch.add, x, y)


def _matmul_impl(x, y, transpose_x, transpose_y):
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return x @ y


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return dispatch("matmul", _matmul_impl, x, y,
                    transpose_x=bool(transpose_x),
                    transpose_y=bool(transpose_y))
