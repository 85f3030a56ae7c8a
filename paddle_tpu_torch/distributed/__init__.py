"""``paddle.distributed`` of the port (counterpart:
``paddle_tpu.distributed``).

- The data plane over ``torch.distributed``: ``init_parallel_env`` and
  the env contract (``env``), the collectives (``collective``, ``stream``,
  ``communication``), the comm plane of pending works (``comm_plane``), the
  quantized wire (``comm_quant``), ``DataParallel`` with bucketed
  gradient sync (``parallel``), ``spawn`` and the launcher
  (``python -m paddle_tpu_torch.distributed.launch``).
- The hybrid plane: the mesh and its groups (``sharding_api``, with
  the multi-slice ``dcn`` axis and ``dcn_grad_sync``), the fleet facade
  and topology, the tensor- and sequence-parallel layers, ZeRO stages 1
  to 3 (``sharding``, ``fleet.meta_parallel.sharding``), context
  parallelism, the pipeline, recompute, the meta-optimizers
  (``fleet.meta_optimizers``), the in-program quantized collectives
  (``comm_quant``), and ``checkpoint``'s shards of split tensors,
  resharded on load.
- The semi-auto API above the hybrid plane (``auto_parallel``:
  ``ProcessMesh``, the placements, ``shard_tensor``/``reshard``/
  ``shard_layer``/``unshard_dtensor``, ``Engine``, ``shard_dataloader``)
  and the fleet executor (``fleet_executor``: a DAG of stage callables
  over microbatches).
- The control plane's pieces ported so far: the membership ``TCPStore``
  over ``native/store/tcp_store.cpp`` (``store``), the clock and
  transport seam (``substrate``), the checkpoint digest gate
  (``elastic.verify_checkpoint``) and ``checkpoint``.

Still to port (ROADMAP A8): elastic launch and RPC.
"""
from .env import (ParallelEnv, ParallelMode, init_parallel_env,  # noqa: F401
                  is_available, is_initialized, get_rank, get_world_size,
                  set_rank_world_size, find_free_port)
from .collective import (ReduceOp, Group, new_group, get_group,  # noqa: F401
                         all_reduce, all_gather, all_gather_object,
                         broadcast, broadcast_object_list,
                         scatter_object_list, reduce, scatter,
                         reduce_scatter, alltoall, alltoall_single, send,
                         recv, isend, irecv, barrier, wait, get_backend,
                         P2POp, batch_isend_irecv, destroy_process_group,
                         P2PTimeout)
from . import comm_plane, comm_quant, stream, communication  # noqa: F401
from .comm_plane import CollectiveWork  # noqa: F401
from .comm_quant import QuantConfig  # noqa: F401
from .parallel import DataParallel, sync_params_buffers  # noqa: F401
from .spawn import spawn  # noqa: F401
from .launch.main import launch  # noqa: F401
from . import sharding_api, sharding, fleet  # noqa: F401
from . import auto_parallel  # noqa: F401
from .auto_parallel import (ProcessMesh, Placement, Shard,  # noqa: F401
                            Replicate, Partial, ReduceType, DistAttr,
                            DistModel, Strategy, shard_tensor,
                            dtensor_from_fn, reshard, shard_layer,
                            shard_dataloader, unshard_dtensor, Engine,
                            to_static)
from . import fleet_executor  # noqa: F401
from .fleet_executor import FleetExecutor, TaskNode, Carrier  # noqa: F401


def get_device():
    from ..framework.place import get_device as _g
    return _g()
