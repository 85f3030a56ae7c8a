"""DistributedStrategy (counterpart: ``paddle_tpu/distributed/fleet/base/
distributed_strategy.py``; upstream wraps distributed_strategy.proto): a
registry with the same field names and defaults, serializable through
to_dict/from_dict. ``fleet.init`` reads ``hybrid_configs`` and publishes
``comm_quant_configs`` as the active ``comm_quant`` config when
``comm_quant`` is set. ``gradient_merge``, ``dgc`` and ``localsgd`` stay
inert, as in the reference: the meta-optimizers are wrapped by hand."""
from __future__ import annotations

import copy


_DEFAULTS = {
    "amp": False,
    "amp_configs": {"init_loss_scaling": 32768.0, "use_pure_fp16": False,
                    "use_fp16_guard": True, "custom_white_list": [],
                    "custom_black_list": []},
    "recompute": False,
    "recompute_configs": {"checkpoints": [], "enable_offload": False},
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "sharding": False,
    "sharding_configs": {"stage": 1, "sharding_degree": 1,
                         "segment_broadcast_MB": 32.0,
                         "comm_overlap": True},
    "pipeline": False,
    "pipeline_configs": {"micro_batch_size": 1, "accumulate_steps": 1,
                         "schedule_mode": "1F1B"},
    "tensor_parallel": False,
    "tensor_parallel_configs": {"tensor_parallel_degree": 1,
                                "tensor_init_seed": -1},
    "hybrid_configs": {"dp_degree": -1, "mp_degree": 1, "pp_degree": 1,
                       "sharding_degree": 1, "sep_degree": 1},
    # quantized collectives (distributed/comm_quant.py); fp32 stays the
    # default (comm_quant=False)
    "comm_quant": False,
    "comm_quant_configs": {"dtype": "int8", "block_size": 256,
                           "scale_dtype": "float32",
                           "error_feedback": True},
    "lamb": False,
    "lars": False,
    "dgc": False,
    "localsgd": False,
    "a_sync": False,
    "find_unused_parameters": False,
    "heter_ccl_mode": False,
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "nccl_comm_num": 1,
    "without_graph_optimization": True,
}


class DistributedStrategy:
    def __init__(self):
        self.__dict__["_fields"] = copy.deepcopy(_DEFAULTS)

    def __getattr__(self, name):
        fields = self.__dict__.get("_fields", {})
        if name in fields:
            return fields[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        fields = self.__dict__["_fields"]
        if name in fields and isinstance(fields[name], dict) and \
                isinstance(value, dict):
            fields[name].update(value)
        else:
            fields[name] = value

    def to_dict(self):
        return copy.deepcopy(self._fields)

    def from_dict(self, d):
        for k, v in d.items():
            setattr(self, k, v)
        return self

    def save_to_prototxt(self, output):
        import json
        with open(output, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def load_from_prototxt(self, pb_file):
        import json
        with open(pb_file) as f:
            self.from_dict(json.load(f))

    def __repr__(self):
        on = [k for k, v in self._fields.items() if v is True]
        return f"DistributedStrategy(enabled={on}, hybrid={self.hybrid_configs})"
