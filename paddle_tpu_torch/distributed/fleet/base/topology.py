"""The hybrid topology (counterpart: ``paddle_tpu/distributed/fleet/base/
topology.py``; upstream ``fleet/base/topology.py``).

``CommunicateTopology`` keeps the reference's rank <-> coordinate order
(``itertools.product`` over the dims: data, pipe, sharding, sep, model).
``HybridCommunicateGroup`` builds the real groups through the mesh
(``sharding_api.Mesh``): data, pipe, sharding, sep and model, one
``torch.distributed`` group each, plus the check group (every axis but
data), every rank creating every group in one order. It makes that mesh
the default, as the reference's does, so the TP layers, ZeRO, the train
step and the checkpoint read the same topology. A multi-slice mesh's dcn
axis is folded into data: the topology's data degree is dcn x dp and its
data group the mesh's ``group("dcn", "dp")``.
"""
from __future__ import annotations

import itertools

from ...env import get_rank
from ...sharding_api import Mesh, set_default_mesh

_NAMES = ("data", "pipe", "sharding", "sep", "model")
_AXIS_OF = {"data": "dp", "pipe": "pp", "sharding": "sharding", "sep": "sep",
            "model": "mp"}


class CommunicateTopology:
    def __init__(self, hybrid_group_names=_NAMES, dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world = 1
        for d in self._dims:
            self._world *= int(d)
        self._coord_of_rank = {}
        self._rank_of_coord = {}
        for rank, coord in enumerate(itertools.product(
                *[range(d) for d in self._dims])):
            self._coord_of_rank[rank] = coord
            self._rank_of_coord[coord] = rank

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[n] for n in self._parallel_names)
        return self._rank_of_coord[coord]

    def get_coord(self, rank):
        return self._coord_of_rank[rank]

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on axis_name == index."""
        ax = self._parallel_names.index(axis_name)
        return [r for r, c in self._coord_of_rank.items() if c[ax] == index]

    def get_comm_list(self, axis_name):
        """Groups of ranks varying only along axis_name."""
        ax = self._parallel_names.index(axis_name)
        groups = {}
        for r, c in self._coord_of_rank.items():
            key = c[:ax] + c[ax + 1:]
            groups.setdefault(key, []).append(r)
        return [sorted(v) for _, v in sorted(groups.items())]

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self._coord_of_rank[global_rank])
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return self._rank_of_coord[tuple(coord)]


class HybridCommunicateGroup:
    """Axis order matches the reference: data, pipe, sharding, sep,
    model. ``mesh``: an existing mesh of the same dims to adopt instead of
    building the groups again."""

    def __init__(self, topology, mesh=None):
        self._topo = topology
        self.global_rank = get_rank() % max(topology.world_size(), 1)
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep")
        self._mp_degree = topology.get_dim("model")
        dims = [topology.get_dim(n) for n in _NAMES]
        if mesh is None or list(mesh.hybrid_dims) != dims:
            mesh = Mesh(dims, rank=self.global_rank)
        self._mesh = set_default_mesh(mesh)
        self._groups = {n: mesh.group(_AXIS_OF[n]) for n in _NAMES}
        if "dcn" in mesh.shape:
            # the topology's data axis is dcn x dp
            self._groups["data"] = mesh.group("dcn", "dp")
        self._groups["check"] = mesh.group("pp", "sharding", "sep", "mp")

    @property
    def mesh(self):
        return self._mesh

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._mp_degree > 1 or self._pp_degree > 1 or \
                self._sharding_degree > 1:
            return "hybrid"
        return "data"

    # -- data parallel --
    def get_data_parallel_rank(self):
        return self._topo.get_coord(self.global_rank)[0]

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._groups["data"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["data"].ranks[0]

    # -- model (tensor) parallel --
    def get_model_parallel_rank(self):
        return self._topo.get_coord(self.global_rank)[4]

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._groups["model"]

    def get_model_parallel_group_src_rank(self):
        return self._groups["model"].ranks[0]

    # -- pipeline --
    def get_stage_id(self):
        return self._topo.get_coord(self.global_rank)[1]

    def get_pipe_parallel_rank(self):
        return self.get_stage_id()

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._groups["pipe"]

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_rank_at_stage(self, stage):
        return self._topo.get_rank_from_stage(self.global_rank, pipe=stage)

    def get_pipe_prev_rank(self):
        s = self.get_stage_id()
        return None if s == 0 else self.get_rank_at_stage(s - 1)

    def get_pipe_next_rank(self):
        s = self.get_stage_id()
        if s == self._pp_degree - 1:
            return None
        return self.get_rank_at_stage(s + 1)

    # -- sharding --
    def get_sharding_parallel_rank(self):
        return self._topo.get_coord(self.global_rank)[2]

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self):
        return self._groups["sharding"].ranks[0]

    # -- sep (context/sequence) --
    def get_sep_parallel_rank(self):
        return self._topo.get_coord(self.global_rank)[3]

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._groups["sep"]

    # -- the found-inf check group (every axis but data) --
    def get_check_parallel_group(self, sharding=False):
        return self._groups["check"]
