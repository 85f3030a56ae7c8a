"""``paddle.distributed.auto_parallel`` (counterpart: ``paddle_tpu/
distributed/auto_parallel/``): not ported yet. Each of the reference's
names raises on access, naming ROADMAP A7."""
from __future__ import annotations

_NAMES = ("ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
          "shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
          "unshard_dtensor", "Engine", "to_static")


def __getattr__(name):
    if name in _NAMES:
        raise NotImplementedError(
            f"auto_parallel.{name} is not ported yet (ROADMAP A7)")
    raise AttributeError(name)
