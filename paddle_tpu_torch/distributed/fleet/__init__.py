"""``paddle.distributed.fleet`` of the port (counterpart:
``paddle_tpu/distributed/fleet/``): the facade (``init``,
``distributed_model``, ``distributed_optimizer``), the strategy, the
topology and its groups, ``meta_parallel`` (TP layers, the RNG tracker,
ZeRO, the hybrid optimizer, the pipeline), ``meta_optimizers``
(GradientMerge, LocalSGD, DGC) and ``utils`` (recompute, sequence
parallelism)."""
from .base.distributed_strategy import DistributedStrategy
from .base.topology import CommunicateTopology, HybridCommunicateGroup
from .fleet_facade import (init, is_first_worker, worker_index, worker_num,
                           distributed_model, distributed_optimizer,
                           get_hybrid_communicate_group, get_strategy,
                           barrier_worker, save_persistables)
from . import meta_parallel
from . import utils
from .utils import recompute
