"""The fleet facade: ``init``, ``distributed_model``,
``distributed_optimizer`` (counterpart: ``paddle_tpu/distributed/fleet/
fleet_facade.py``; upstream ``fleet/fleet.py``).

``init`` joins the world (``init_parallel_env``), reads the degrees of
``strategy.hybrid_configs`` (``dp_degree`` -1 takes the rest of the
world; ``pp_degree`` the pipeline's stages, with ``strategy.
pipeline_configs``; ``dcn_dp_degree`` an outermost ``dcn`` axis of
multi-slice data parallelism, folded into data in the topology), builds
the mesh and its groups and makes it the default, so the TP layers,
ZeRO, the pipeline, ``CompiledTrainStep``, ``Model.fit`` and the
checkpoint read one topology. With ``strategy.comm_quant`` set it
publishes ``QuantConfig.from_strategy(strategy.comm_quant_configs)`` as
the active config (``DataParallel(comm_quant=None)`` and
``GroupShardedStage3.get_all_parameters()`` read it), and clears it
otherwise. ``distributed_model`` wraps the model in a ``DataParallel``
over the data axes only (dcn x dp x sharding), never over mp or sep (the
optimizer's step sums gradients over sep), and a ``PipelineLayer`` in a
``PipelineParallel``.
``distributed_optimizer`` wraps the optimizer in a
``HybridParallelOptimizer`` (the global-norm clip across the groups);
with a sharding degree above 1 it first shards the optimizer's state over
the sharding group (ZeRO stage 1), as upstream's does.
"""
from __future__ import annotations

from ..env import get_rank, get_world_size, init_parallel_env
from .base.distributed_strategy import DistributedStrategy
from .base.topology import CommunicateTopology, HybridCommunicateGroup

_fleet_state = {"initialized": False, "strategy": None, "hcg": None}


def init(role_maker=None, is_collective=True, strategy=None, log_level="INFO"):
    init_parallel_env()
    strategy = strategy or DistributedStrategy()
    world = max(get_world_size(), 1)
    hc = dict(strategy.hybrid_configs)
    mp = int(hc.get("mp_degree", 1))
    pp = int(hc.get("pp_degree", 1))
    sh = int(hc.get("sharding_degree", 1))
    sep = int(hc.get("sep_degree", 1))
    dcn = int(hc.get("dcn_dp_degree", 1))
    dp = int(hc.get("dp_degree", -1))
    if dp == -1:
        dp = max(world // (mp * pp * sh * sep * dcn), 1)
    from ..sharding_api import build_mesh
    mesh = build_mesh(dp=dp, pp=pp, sharding=sh, sep=sep, mp=mp,
                      dcn_dp=dcn)
    # the topology folds dcn into data; the mesh keeps the dcn axis
    topo = CommunicateTopology(dims=(dp * dcn, pp, sh, sep, mp))
    hcg = HybridCommunicateGroup(topo, mesh=mesh)
    # the comm_quant field: DataParallel and the ZeRO-3 gather read the
    # active config when they sync (fp32 when the field is off)
    from .. import comm_quant as _cq
    if strategy.comm_quant:
        _cq.set_active_config(
            _cq.QuantConfig.from_strategy(strategy.comm_quant_configs))
    else:
        _cq.set_active_config(None)
    _fleet_state.update(initialized=True, strategy=strategy, hcg=hcg)
    return None


def _ensure_init():
    if not _fleet_state["initialized"]:
        init()


def get_hybrid_communicate_group():
    _ensure_init()
    return _fleet_state["hcg"]


def get_strategy():
    _ensure_init()
    return _fleet_state["strategy"]


def is_first_worker():
    return get_rank() == 0


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def barrier_worker():
    from ..collective import barrier
    barrier()


def distributed_model(model):
    """``model`` in a ``DataParallel`` over the data axes (dcn x dp x
    sharding) of the fleet's mesh; a ZeRO-2/3 model
    (``group_sharded_parallel``'s) as it is, since its gradients are
    averaged onto their rows by its own rules; a ``PipelineLayer`` in a
    ``PipelineParallel`` over the pp axis (its ``train_batch`` averages
    each stage's gradients over the data axes itself)."""
    _ensure_init()
    from .meta_parallel.pp_layers import PipelineLayer
    from .meta_parallel.sharding import GroupShardedStage2, GroupShardedStage3
    if isinstance(model, PipelineLayer):
        from .meta_parallel.pipeline_parallel import PipelineParallel
        return PipelineParallel(model, _fleet_state["hcg"],
                                _fleet_state["strategy"])
    if isinstance(model, (GroupShardedStage2, GroupShardedStage3)):
        return model
    from ..parallel import DataParallel
    mesh = _fleet_state["hcg"].mesh
    return DataParallel(model, group=mesh.group(*mesh.data_axes))


def distributed_optimizer(optimizer, strategy=None):
    _ensure_init()
    hcg = _fleet_state["hcg"]
    from .meta_parallel.hybrid_optimizer import HybridParallelOptimizer
    if hcg.get_sharding_parallel_world_size() > 1:
        from .meta_parallel.sharding import shard_optimizer_state
        inner = getattr(optimizer, "_inner_opt", optimizer)
        shard_optimizer_state(inner, inner._parameter_list(), "os")
    return HybridParallelOptimizer(optimizer, hcg,
                                   strategy or _fleet_state["strategy"])


def save_persistables(executor_or_model, dirname, main_program=None,
                      mode=0, **kwargs):
    """The model's ``state_dict`` to ``dirname/persistables.pdparams``,
    written by the first worker (the ranks would write one file at once);
    a split model's whole state goes through ``distributed.checkpoint``."""
    from ...framework.io import save
    if hasattr(executor_or_model, "state_dict") and is_first_worker():
        save(executor_or_model.state_dict(), f"{dirname}/persistables.pdparams")
