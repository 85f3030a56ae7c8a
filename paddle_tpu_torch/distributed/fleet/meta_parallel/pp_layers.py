"""Pipeline layer descriptions (counterpart: ``paddle_tpu/distributed/fleet/
meta_parallel/pp_layers.py``; upstream ``fleet/meta_parallel/
parallel_layers/pp_layers.py``). ``PipelineLayer`` partitions a layer list
into stages; ``PipelineParallel`` (``pipeline_parallel.py``) runs them.

- ``LayerDesc(layer_func, *inputs, **kwargs)`` builds a layer on demand;
  ``SharedLayerDesc`` names a layer shared by several places of the list
  (built once, its ``forward_func`` applied where given).
- ``PipelineLayer`` builds every description in list order, so every rank
  draws the same seeded init stream; a plain callable is a ``"func"``
  entry applied as it is. The stage bounds are ``round(i·n/stages)`` over
  the run list (``_segment``).
- ``shard_to_stage(stage)`` keeps that stage's segment: ``run_list``
  shrinks and ``sublist`` (a registered module list) holds its layers, so
  ``parameters()`` and an optimizer built after it see the stage's alone,
  bit-equal to the same part of a one-process build. It is idempotent per
  stage, refuses a second stage, and refuses ``SharedLayerDesc`` ties
  (a weight shared across stages cannot live on one rank).
"""
from __future__ import annotations

from torch import nn

from ....nn.layer.layers import Layer


class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._num_stages = num_stages or 1
        self._seg_method = seg_method
        self._shared = {}
        built = []
        for desc in layers:
            if isinstance(desc, SharedLayerDesc):
                layer = self._shared.get(desc.layer_name)
                if layer is None:
                    layer = self._shared[desc.layer_name] = desc.build_layer()
                built.append((layer, desc.forward_func))
            elif isinstance(desc, LayerDesc):
                built.append((desc.build_layer(), None))
            elif isinstance(desc, nn.Module):
                built.append((desc, None))
            elif callable(desc):
                built.append((desc, "func"))
            else:
                raise TypeError(f"bad layer desc {desc!r}")
        self.run_list = built
        self.sublist = nn.ModuleList(
            [l for l, _ in built if isinstance(l, nn.Module)])
        self._sharded_stage = None
        self._segment()

    def _segment(self):
        n = len(self.run_list)
        stages = self._num_stages
        self._stage_bounds = [int(round(i * n / stages))
                              for i in range(stages + 1)]

    def get_stage_layers(self, stage_id):
        lo, hi = self._stage_bounds[stage_id], self._stage_bounds[stage_id + 1]
        return self.run_list[lo:hi]

    def shard_to_stage(self, stage_id):
        """Keep only ``stage_id``'s segment (after the whole build, so the
        init stream is every rank's). Call once at wiring time."""
        if self._sharded_stage is not None:
            if self._sharded_stage != stage_id:
                raise RuntimeError(
                    f"PipelineLayer already sharded to stage "
                    f"{self._sharded_stage}; cannot re-shard to {stage_id}")
            return
        if self._shared:
            raise NotImplementedError(
                "stage sharding with SharedLayerDesc ties is not supported: "
                "a weight shared across stages cannot live on one rank")
        self.run_list = self.get_stage_layers(stage_id)
        self.sublist = nn.ModuleList(
            [l for l, _ in self.run_list if isinstance(l, nn.Module)])
        self._sharded_stage = stage_id

    def forward(self, x):
        for layer, ffunc in self.run_list:
            if ffunc is None or ffunc == "func":
                x = layer(x)
            else:
                x = ffunc(layer, x)
        return x
