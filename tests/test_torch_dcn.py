"""The DCN axis of the port's mesh (``paddle_tpu_torch/distributed/
sharding_api.py``, ``fleet/fleet_facade.py``, ``fleet/base/topology.py``)
against the reference's, in one process with no process group: the
port's mesh over four or eight ranks is a layout whose groups are rank
lists. The collectives over the dcn group (``dcn_grad_sync``,
``hierarchical_all_reduce``) run across four gloo ranks in
``tests/test_torch_comm_quant_program.py``.

- ``build_mesh(dcn_dp=2)``: the outermost ``dcn`` axis, the axis names
  and sizes of the reference's mesh, the remainder rule and its
  ``ValueError`` with dcn in the product, and the rank lists along each
  axis equal to the reference's device ids along it.
- The batch axes at dcn 2 x dp 2: ``mesh_batch_axes`` (dp and sharding)
  equal to the reference's; the mesh's ``data_axes`` (dcn, dp and
  sharding) of size above 1 equal to the reference's TP layers'
  ``_batch_axes`` (``mp_layers.py:49-56``; ``spmd_pipeline.py:197-199``
  keeps the same list), and a rank's rows follow them.
- ``fleet.init`` with ``dcn_dp_degree`` 2: the topology folds dcn into
  data (``CommunicateTopology(dims=(dp·dcn, ...))``, as the reference's
  ``fleet_facade.py:27``), every rank's data group and rank equal to the
  reference's, while the mesh keeps its dcn axis; ``strategy.comm_quant``
  publishes the strategy's config and clears it
  (``tests/test_comm_quant.py:393-414``).
- ``dcn_grad_sync`` on a mesh without a dcn axis returns its value, at
  once and as a completed work; a checkpoint writer is the rank at
  coordinate 0 of every replicated axis, dcn included.
"""
import pytest
import torch

import paddle_tpu.distributed.env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import fleet_facade as jfacade
from paddle_tpu.distributed.sharding_api import (build_mesh as jbuild_mesh,
                                                 mesh_batch_axes as jbatch,
                                                 set_default_mesh as jset)
from paddle_tpu_torch.distributed import comm_quant as cq
from paddle_tpu_torch.distributed import env as penv
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import sharding_api as sa
from paddle_tpu_torch.distributed.fleet import fleet_facade


@pytest.fixture(autouse=True)
def _restore():
    yield
    jset(None)
    sa.set_default_mesh(None)
    jenv.set_rank_world_size(None, None)
    penv.set_rank_world_size(None, None)
    cq.set_active_config(None)
    fleet_facade._fleet_state.update(initialized=False, strategy=None,
                                     hcg=None)
    jfacade._fleet_state["initialized"] = False


def _jax_devices(n):
    import jax
    return jax.devices()[:n]


@pytest.mark.parametrize("degrees,world", [
    (dict(dcn_dp=2), 8), (dict(dp=2, dcn_dp=2), 4),
    (dict(mp=2, dcn_dp=2), 8), (dict(dp=1, sharding=2, dcn_dp=2), 8),
    (dict(dcn_dp=4, mp=2), 8)])
def test_build_mesh_adds_the_outer_dcn_axis(degrees, world):
    got = sa.build_mesh(devices=world, **degrees)
    want = jbuild_mesh(devices=_jax_devices(world), **degrees)
    assert tuple(got.axis_names) == tuple(want.axis_names) == \
        ("dcn",) + sa.AXES
    assert got.shape == dict(want.shape)
    ids = want.devices
    for axis in got.axis_names:
        k = want.axis_names.index(axis)
        lists = sorted(sorted(int(d.id) for d in row.reshape(-1))
                       for row in ids.swapaxes(k, -1).reshape(-1,
                                                              ids.shape[k]))
        assert got.comm_lists((axis,)) == lists, axis


@pytest.mark.parametrize("degrees", [dict(mp=3, dcn_dp=2),
                                     dict(dp=3, dcn_dp=3)])
def test_build_mesh_refuses_degrees_that_do_not_divide(degrees):
    with pytest.raises(ValueError, match="do not multiply"):
        sa.build_mesh(devices=8, **degrees)
    with pytest.raises(ValueError, match="do not multiply"):
        jbuild_mesh(devices=_jax_devices(8), **degrees)


def test_batch_axes_at_dcn_2_by_dp_2():
    from paddle_tpu.distributed.fleet.meta_parallel.mp_layers import \
        _batch_axes
    jmesh = jset(jbuild_mesh(dp=2, dcn_dp=2, devices=_jax_devices(4)))
    mesh = sa.build_mesh(dp=2, dcn_dp=2, devices=4)
    assert sa.mesh_batch_axes(mesh) == jbatch(jmesh) == ("dp",)
    assert mesh.data_axes == ("dcn", "dp", "sharding")
    assert tuple(a for a in mesh.data_axes if mesh.shape[a] > 1) == \
        _batch_axes() == ("dcn", "dp")
    assert mesh.degree(*mesh.data_axes) == 4
    for r in range(4):
        m = sa.Mesh(mesh.dims, rank=r, axis_names=mesh.axis_names)
        assert sa.data_rank_world(m) == (r, 4)
    assert sa.build_mesh(dp=2, mp=2, devices=4).data_axes == sa.DATA_AXES


@pytest.mark.parametrize("rank", range(4))
def test_fleet_init_folds_dcn_into_data(monkeypatch, rank):
    hc = {"dp_degree": 2, "dcn_dp_degree": 2}
    jenv.set_rank_world_size(rank, 4)
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = hc
    monkeypatch.setattr(jfacade, "init_parallel_env", lambda: None)
    jfacade._fleet_state["initialized"] = False
    import jax
    devices = _jax_devices(4)
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    jfleet.init(strategy=s)
    want = jfleet.get_hybrid_communicate_group()
    penv.set_rank_world_size(rank, 4)
    monkeypatch.setattr(fleet_facade, "init_parallel_env", lambda: None)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = hc
    fleet.init(strategy=s)
    got = fleet.get_hybrid_communicate_group()
    assert got.topology()._dims == want.topology()._dims == [4, 1, 1, 1, 1]
    assert got.get_data_parallel_world_size() == \
        want.get_data_parallel_world_size() == 4
    assert got.get_data_parallel_rank() == want.get_data_parallel_rank()
    assert got.get_data_parallel_group().ranks == [0, 1, 2, 3]
    mesh = sa.get_default_mesh()
    assert mesh is got.mesh and mesh.shape["dcn"] == 2
    assert mesh.group("dcn").ranks == [rank % 2, rank % 2 + 2]
    assert mesh.group("dp").ranks == [2 * (rank // 2), 2 * (rank // 2) + 1]


def test_fleet_init_publishes_and_clears_the_active_config(monkeypatch):
    monkeypatch.setattr(fleet_facade, "init_parallel_env", lambda: None)
    penv.set_rank_world_size(0, 1)
    s = fleet.DistributedStrategy()
    s.comm_quant = True
    s.comm_quant_configs = {"block_size": 128, "error_feedback": False}
    fleet.init(strategy=s)
    cfg = cq.get_active_config()
    assert cfg is not None and cfg.block_size == 128
    assert cfg.error_feedback is False
    assert cq.resolve_config(True) is cfg
    fleet.init(strategy=fleet.DistributedStrategy())
    assert cq.get_active_config() is None


@pytest.mark.parametrize("async_op", [False, True])
def test_dcn_grad_sync_without_a_dcn_axis_returns_the_value(async_op):
    g = torch.arange(6, dtype=torch.float32)
    mesh = sa.build_mesh(dp=1, devices=1)
    got = sa.dcn_grad_sync(g, mesh, quant=True, async_op=async_op)
    if async_op:
        assert got.is_completed()
        got = got.result()
    assert got is g


def test_a_whole_tensor_is_written_by_dcn_0_and_dp_0():
    mesh = sa.build_mesh(dp=2, dcn_dp=2, devices=4)
    whole = sa.Placement.whole((3,))
    writers = [whole.writer(sa.Mesh(mesh.dims, rank=r,
                                    axis_names=mesh.axis_names))
               for r in range(4)]
    assert writers == [True, False, False, False]
