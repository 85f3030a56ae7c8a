"""The hybrid topology of the port (``paddle_tpu_torch/distributed/
{sharding_api,fleet/base/topology,fleet/fleet_facade}.py``) against the
reference's, in one process with no process group: the port's mesh over
eight ranks is a layout whose groups are rank lists.

- ``CommunicateTopology``: every coordinate, comm list, axis list, rank
  and stage lookup equal to the reference's for dims (2, 1, 2, 1, 2).
- ``HybridCommunicateGroup`` for each of the eight ranks (both packages'
  rank override): every group's rank list and every rank and world-size
  query equal to the reference's.
- ``build_mesh``: the remainder goes to dp, a degree set that cannot
  multiply to the world raises ``ValueError`` in both packages (the DCN
  axis builds: ``tests/test_torch_dcn.py``). A sep axis alone builds
  (context parallelism, ``tests/test_torch_context_parallel.py``), and so
  does a pp axis, and pp with sep (pp 4 x sep 2, dp 2 x pp 2 x sep 2):
  their groups equal the reference's.
- ``fleet.init``'s mesh for dp 4 x mp 2 (``tests/test_fleet_e2e.py:68``):
  the reference's axis order and sizes.
- A ``Model`` over a one-process ``PipelineParallel`` builds; over one
  whose pp group spans processes it raises, naming ROADMAP A7. Every name the reference exports from
  ``auto_parallel`` and the fleet executor resolves on
  ``paddle_tpu_torch.distributed``.
"""
import pytest

import paddle_tpu.distributed.env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.base.topology import (
    CommunicateTopology as JTopology, HybridCommunicateGroup as JHCG)
from paddle_tpu.distributed.sharding_api import (build_mesh as jbuild_mesh,
                                                 set_default_mesh as jset)
from paddle_tpu_torch.distributed import env as penv
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import sharding_api as sa
from paddle_tpu_torch.distributed.fleet import fleet_facade
from paddle_tpu_torch.distributed.fleet.base.topology import (
    CommunicateTopology, HybridCommunicateGroup)

DIMS = (2, 1, 2, 1, 2)
NAMES = ("data", "pipe", "sharding", "sep", "model")


@pytest.fixture(autouse=True)
def _restore():
    yield
    jset(None)
    sa.set_default_mesh(None)
    jenv.set_rank_world_size(None, None)
    penv.set_rank_world_size(None, None)
    fleet_facade._fleet_state.update(initialized=False, strategy=None,
                                     hcg=None)


def test_topology_matches_the_reference():
    got, want = CommunicateTopology(dims=DIMS), JTopology(dims=DIMS)
    assert got.world_size() == want.world_size() == 8
    for r in range(8):
        assert got.get_coord(r) == want.get_coord(r)
        coord = dict(zip(NAMES, got.get_coord(r)))
        assert got.get_rank(**coord) == want.get_rank(**coord) == r
        assert got.get_rank_from_stage(r, model=0) == \
            want.get_rank_from_stage(r, model=0)
    for name in NAMES:
        assert got.get_dim(name) == want.get_dim(name)
        assert got.get_comm_list(name) == want.get_comm_list(name)
        for i in range(got.get_dim(name)):
            assert got.get_axis_list(name, i) == want.get_axis_list(name, i)


@pytest.mark.parametrize("rank", range(8))
def test_hybrid_group_matches_the_reference(rank):
    jenv.set_rank_world_size(rank, 8)
    penv.set_rank_world_size(rank, 8)
    got = HybridCommunicateGroup(CommunicateTopology(dims=DIMS))
    want = JHCG(JTopology(dims=DIMS))
    for q in ("data_parallel", "model_parallel", "sharding_parallel",
              "sep_parallel", "pipe_parallel"):
        assert getattr(got, f"get_{q}_rank")() == \
            getattr(want, f"get_{q}_rank")(), q
        assert getattr(got, f"get_{q}_world_size")() == \
            getattr(want, f"get_{q}_world_size")(), q
        assert getattr(got, f"get_{q}_group")().ranks == \
            getattr(want, f"get_{q}_group")().ranks, q
    assert got.get_parallel_mode() == want.get_parallel_mode() == "hybrid"
    assert got.get_pipe_prev_rank() == want.get_pipe_prev_rank()
    assert got.get_pipe_next_rank() == want.get_pipe_next_rank()
    # the port's extra groups: the data axes together and the check group
    mesh = got.mesh
    assert sa.get_default_mesh() is mesh
    data = mesh.group("dp", "sharding").ranks
    assert len(data) == 4 and rank in data
    for r in data:
        assert got.topology().get_coord(r)[4] == \
            got.get_model_parallel_rank()
    check = got.get_check_parallel_group().ranks
    assert len(check) == 4 and all(
        got.topology().get_coord(r)[0] == got.get_data_parallel_rank()
        for r in check)


@pytest.mark.parametrize("dims", [(1, 2, 1, 1, 1), (1, 4, 1, 1, 1),
                                  (2, 4, 1, 1, 1), (2, 2, 1, 1, 2)])
def test_pipe_queries_match_the_reference_at_pp_2_and_4(dims):
    """Stage ids, neighbours and the rank of every stage, in the order
    data, pipe, sharding, sep, model, for each rank."""
    world = 1
    for d in dims:
        world *= d
    for rank in range(world):
        jenv.set_rank_world_size(rank, world)
        penv.set_rank_world_size(rank, world)
        got = HybridCommunicateGroup(CommunicateTopology(dims=dims))
        want = JHCG(JTopology(dims=dims))
        assert got.get_stage_id() == want.get_stage_id()
        assert got.is_first_stage() == want.is_first_stage()
        assert got.is_last_stage() == want.is_last_stage()
        assert got.get_pipe_prev_rank() == want.get_pipe_prev_rank()
        assert got.get_pipe_next_rank() == want.get_pipe_next_rank()
        assert got.get_pipe_parallel_group().ranks == \
            want.get_pipe_parallel_group().ranks
        for stage in range(dims[1]):
            assert got.get_rank_at_stage(stage) == \
                want.get_rank_at_stage(stage)


@pytest.mark.parametrize("degrees,world", [
    (dict(dp=1, mp=2), 8), (dict(dp=1, sharding=2, mp=2), 8),
    (dict(dp=3, mp=2), 8), (dict(dp=8), 8), (dict(mp=2), 2)])
def test_build_mesh_remainder_goes_to_dp(degrees, world):
    import jax
    got = sa.build_mesh(devices=world, **degrees)
    want = jbuild_mesh(devices=jax.devices()[:world], **degrees)
    assert tuple(got.axis_names) == tuple(want.axis_names)
    assert got.shape == dict(want.shape)


@pytest.mark.parametrize("degrees", [dict(mp=3), dict(dp=2, mp=3)])
def test_build_mesh_refuses_degrees_that_do_not_divide(degrees):
    with pytest.raises(ValueError, match="do not multiply"):
        sa.build_mesh(devices=8, **degrees)
    with pytest.raises(ValueError, match="do not multiply"):
        jbuild_mesh(**degrees)


@pytest.mark.parametrize("degrees", [dict(pp=4, sep=2), dict(pp=2, sep=2)])
def test_the_rest_raises_naming_a7(degrees):
    """The pipeline on a sep mesh, once refused naming ROADMAP A7, builds:
    the reference's axis sizes (the remainder to dp) and, on every axis,
    the reference topology's comm lists."""
    import jax
    mesh = sa.build_mesh(devices=8, **degrees)
    jmesh = jbuild_mesh(devices=jax.devices()[:8], **degrees)
    assert mesh.shape == {a: jmesh.shape.get(a, 1) for a in sa.AXES}
    topo = JTopology(dims=list(mesh.dims))
    for axis, name in zip(sa.AXES, NAMES):
        assert mesh.comm_lists((axis,)) == topo.get_comm_list(name), axis


@pytest.mark.parametrize("degrees", [dict(pp=2), dict(pp=4),
                                     dict(dp=2, pp=2, mp=2)])
def test_a_pp_axis_builds_with_the_reference_groups(degrees):
    mesh = sa.build_mesh(devices=8, **degrees)
    jmesh = jbuild_mesh(**degrees)
    assert mesh.shape == {a: jmesh.shape.get(a, 1) for a in sa.AXES}
    topo = JTopology(dims=list(mesh.dims))
    assert mesh.comm_lists(("pp",)) == topo.get_comm_list("pipe")


def test_fleet_init_axis_order_matches_the_reference(monkeypatch):
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 4, "mp_degree": 2}
    jfleet.init(strategy=strategy)
    from paddle_tpu.distributed.sharding_api import get_default_mesh
    want = get_default_mesh()
    # eight ranks as a layout: no process group in this process
    penv.set_rank_world_size(0, 8)
    monkeypatch.setattr(fleet_facade, "init_parallel_env", lambda: None)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 4, "mp_degree": 2}
    fleet.init(strategy=strategy)
    got = sa.get_default_mesh()
    assert tuple(got.axis_names) == tuple(want.axis_names) == \
        ("dp", "pp", "sharding", "sep", "mp")
    assert got.shape == dict(want.shape)
    hcg = fleet.get_hybrid_communicate_group()
    assert hcg.mesh is got
    assert hcg.get_model_parallel_group().ranks == [0, 1]
    assert sa.mesh_batch_axes(got) == ("dp",)
    assert sa.data_rank_world(got) == (0, 4)


def test_distributed_model_leaves_a_zero_model_as_it_is(monkeypatch):
    """A ZeRO-2/3 model averages its own gradients onto their rows: no
    ``DataParallel`` over it."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.parallel import DataParallel
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.optimizer import AdamW
    monkeypatch.setattr(fleet_facade, "init_parallel_env", lambda: None)
    fleet.init(strategy=fleet.DistributedStrategy())
    for level in ("os_g", "p_g_os"):
        net = nn.Linear(4, 4, device="cpu")
        model, _, _ = group_sharded_parallel(
            net, AdamW(parameters=net.parameters()), level)
        assert fleet.distributed_model(model) is model
    assert isinstance(fleet.distributed_model(net), DataParallel)


# what the reference's paddle_tpu/distributed/__init__.py exports from
# auto_parallel and fleet_executor
_SEMI_AUTO_NAMES = [
    ("auto_parallel", n) for n in (
        "ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
        "ReduceType", "DistAttr", "DistModel", "Strategy", "shard_tensor",
        "dtensor_from_fn", "reshard", "shard_layer", "shard_dataloader",
        "unshard_dtensor", "Engine", "to_static")] + [
    ("fleet_executor", n) for n in ("FleetExecutor", "TaskNode", "Carrier")]


@pytest.mark.parametrize("module,name", _SEMI_AUTO_NAMES)
def test_semi_auto_and_executor_names_resolve(module, name):
    """Each name resolves on ``paddle_tpu_torch.distributed`` to the port's
    own object in its module, as the reference exports it."""
    import importlib

    import paddle_tpu_torch.distributed as dist
    mod = importlib.import_module(f"paddle_tpu_torch.distributed.{module}")
    assert getattr(dist, name) is getattr(mod, name)
    assert callable(getattr(dist, name))


def test_pipeline_classes_raise_naming_a7():
    """The pipeline's classes are ported; a ``Model`` over a one-process
    ``PipelineParallel`` builds, and what of the pipeline is left raises
    naming ROADMAP A7: a ``Model`` over one whose stages are processes."""
    import torch

    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar
    from paddle_tpu_torch.hapi.model import Model
    layer = mpar.PipelineLayer([mpar.LayerDesc(torch.nn.Tanh)],
                               num_stages=1)
    pipe = mpar.PipelineParallel(layer, None, None)
    assert Model(pipe).network is pipe
    pipe._multi = True     # as built when the pp ranks are processes
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        Model(pipe)
