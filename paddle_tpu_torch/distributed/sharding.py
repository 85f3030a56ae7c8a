"""``paddle.distributed.sharding`` (counterpart: ``paddle_tpu/
distributed/sharding.py``; upstream ``python/paddle/distributed/
sharding/``): the public home of the group-sharded (ZeRO) entry points,
implemented in ``fleet/meta_parallel/sharding.py``."""
from .fleet.meta_parallel.sharding import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]
