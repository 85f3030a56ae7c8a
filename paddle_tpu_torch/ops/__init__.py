"""The op library (counterpart: ``paddle_tpu/ops/``): the op table and
its registry, the op families, the per-op seam and the hand-written
kernels' bindings (``cuda_kernels``)."""
from . import cuda_kernels
from . import (common, comparison, creation, dispatch, indexing, linalg,
               manipulation, math, random_ops, registry)

# modules whose public callables become both ``paddle.*`` functions and
# Tensor methods
_OP_MODULES = [math, manipulation, comparison, linalg, creation, random_ops]

# functions whose home module is one of these are ops; anything else in
# an op module's namespace is an imported helper and must not leak into
# the paddle namespace
_OP_HOMES = {"paddle_tpu_torch.ops." + m for m in (
    "math", "manipulation", "comparison", "linalg", "creation",
    "random_ops", "indexing", "registry")}


def collect_public_ops():
    """name -> function for every public op of the family modules."""
    out = {}
    for mod in _OP_MODULES:
        for name, fn in vars(mod).items():
            if name.startswith("_") or not callable(fn) \
                    or isinstance(fn, type):
                continue
            if getattr(fn, "__module__", "") not in _OP_HOMES:
                continue
            out.setdefault(name, fn)
    return out


__all__ = ["cuda_kernels", "collect_public_ops"]
