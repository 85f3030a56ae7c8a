"""Gradient clipping (counterpart: ``paddle_tpu/nn/clip.py``).

Each class takes a list of (parameter, gradient) pairs and returns a new
list with the gradients clipped; a ``None`` gradient passes through.
``Optimizer.step`` applies a ``grad_clip`` this way, and
``CompiledTrainStep`` applies its functional form
(``jit/train_step.py``, ``_functional_clip``), as the JAX package does.
"""
from __future__ import annotations

import torch


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm:
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g)))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm:
    """All gradients scaled together so that their joint L2 norm, taken in
    fp32, is at most ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def global_scale(self, grads):
        """The fp32 factor every gradient is multiplied by (0-d tensor)."""
        sq = sum(torch.sum(torch.square(g.float())) for g in grads)
        return torch.clamp(self.clip_norm / torch.clamp(torch.sqrt(sq),
                                                        min=1e-12), max=1.0)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        scale = self.global_scale(grads)
        return [(p, g if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]
