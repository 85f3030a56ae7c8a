"""The fleet meta-optimizers (counterpart: ``paddle_tpu/distributed/
fleet/meta_optimizers.py``): ``GradientMergeOptimizer``,
``LocalSGDOptimizer`` and ``DGCOptimizer`` are importable and raise on
use; they wait for ROADMAP A7."""
from __future__ import annotations


def _refuse(name):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP A7)")
    return __init__


class GradientMergeOptimizer:
    __init__ = _refuse("GradientMergeOptimizer")


class LocalSGDOptimizer:
    __init__ = _refuse("LocalSGDOptimizer")


class DGCOptimizer:
    __init__ = _refuse("DGCOptimizer")
