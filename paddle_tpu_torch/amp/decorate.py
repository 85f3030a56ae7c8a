"""``amp.decorate``: O2 decoration of models and optimizers (upstream
``python/paddle/amp/auto_cast.py: decorate``).

Counterpart: ``paddle_tpu/amp/decorate.py``. At O2 every floating
parameter of each ``nn.Module`` is cast to the amp dtype in place (the
``Parameter`` object stays, so an optimizer built before keeps it);
buffers (batch-norm statistics) stay as they are; and each optimizer gets
``_multi_precision`` (from ``master_weight`` when given), so its update
runs on fp32 master weights. O1 changes nothing.
"""
from __future__ import annotations

import torch

from .auto_cast import to_torch_dtype


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    if level not in ("O1", "O2"):
        raise ValueError("level must be O1 or O2")
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        target = to_torch_dtype(dtype)
        for m in model_list:
            _cast_model(m, target)
        if optimizers is not None:
            opts = optimizers if isinstance(optimizers, (list, tuple)) \
                else [optimizers]
            for opt in opts:
                opt._multi_precision = True if master_weight is None \
                    else bool(master_weight)
    if optimizers is None:
        return models
    return models, optimizers


@torch.no_grad()
def _cast_model(layer, target):
    for p in layer.parameters():
        if p.is_floating_point() and p.dtype != target:
            p.data = p.data.to(target)
    return layer
