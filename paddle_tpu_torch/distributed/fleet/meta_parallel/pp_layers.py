"""The pipeline's classes (counterpart: ``paddle_tpu/distributed/fleet/
meta_parallel/{pp_layers,pipeline_parallel}.py``): importable, and each
raises on use; the pipeline, its 1F1B and zero-bubble schedules and the
stage-boundary sends wait for ROADMAP A7."""
from __future__ import annotations


def _refuse(name):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name}: the pipeline is not ported yet (ROADMAP A7)")
    return __init__


class LayerDesc:
    __init__ = _refuse("LayerDesc")


class SharedLayerDesc(LayerDesc):
    __init__ = _refuse("SharedLayerDesc")


class PipelineLayer:
    __init__ = _refuse("PipelineLayer")


class PipelineParallel:
    __init__ = _refuse("PipelineParallel")
