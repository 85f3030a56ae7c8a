"""The hybrid mesh (counterpart: ``paddle_tpu/distributed/sharding_api.py``).

The reference's mesh is a ``jax.sharding.Mesh`` over devices, and GSPMD
puts the collectives in. The port has one process per rank, so its mesh
is a plain object: the axis sizes in the reference's order ``AXES``
(outermost dp, then pp, sharding, sep, mp), this rank's coordinate, and
the ``torch.distributed`` groups each layer and the train step issue
their collectives over:

- one group per axis (the ranks that differ only along it), the data
  axes together (``group("dp", "sharding")``: the gradient average) and
  the check group (every axis but dp, where upstream checks found-inf);
- a rank's coordinate is its position in ``itertools.product`` over the
  axis sizes, as the reference's ``CommunicateTopology`` orders ranks;
- every rank creates every group, in one order, including those it is
  not in (``torch.distributed.new_group`` needs all ranks; a different
  order deadlocks); a group of one rank has no process group and its
  collectives are identities.

``build_mesh`` keeps the reference's degree rule: degrees that do not
multiply to the world give the remainder to dp, and still-wrong degrees
raise ``ValueError``. The sep axis carries context parallelism
(``ops/ring_attention.py``, ``nn.functional.sep_parallel_attention``):
its ranks share a batch's rows and split its sequence
(``sep_local_batch``). The pp axis carries the pipeline
(``fleet/meta_parallel/{pipeline_parallel,spmd_pipeline}.py``): its ranks
share a batch's rows, each holding one stage's layers, and so do the mp
ranks of a data rank (the reference's ``P(("sharding",), None)`` batch),
so ``data_rank_world`` and ``process_local_batch`` stay over the data
axes. On a mesh with both pp and sep above 1 the pipeline keeps the
reference's batch over the data axes only: every sep rank runs the whole
sequence through its pp group, and its gradients take no sum over sep.

A ``Placement`` names the piece of a global tensor a rank holds and the
axes it is split over, by dimension: a stacked pipeline leaf under tensor
parallelism and ZeRO is its stage's rows over pp, then its column or row
range over mp, then its ZeRO rows over sharding (``narrow`` composes
each cut), so ``distributed.checkpoint`` and ``convert`` rebuild the
global value from the pieces.

Multi-slice data parallelism: ``build_mesh(dcn_dp=n)`` with n > 1 adds an
outermost ``dcn`` axis (``mesh.axis_names`` is then ``("dcn",) + AXES``)
with its own group. It is a data axis: ``mesh.data_axes`` (dcn x dp x
sharding) is what the train step, ``fleet.distributed_model`` and
``data_rank_world`` average and shard the batch over, as the reference's
TP layers and SPMD pipeline shard the batch over (dcn, dp, sharding).
``mesh_batch_axes`` keeps the reference's dp and sharding.
``dcn_grad_sync`` averages a gradient this rank holds over the dcn group
alone, in fp32 or through the quantized two-phase ring
(``comm_quant.quantized_all_reduce``), at once or as a pending comm-plane
work.

``process_local_batch`` keeps its contract: each process keeps its own
rows (a rank already holds them: nothing is assembled), and a ragged
batch raises ``ValueError`` naming every process's row count.
``replicated_batch`` checks that every rank holds the same batch.
"""
from __future__ import annotations

import itertools

import torch

AXES = ("dp", "pp", "sharding", "sep", "mp")
DATA_AXES = ("dp", "sharding")
_CHECK_AXES = ("pp", "sharding", "sep", "mp")

_default_mesh = None


def _prod(xs):
    n = 1
    for x in xs:
        n *= int(x)
    return n


class Mesh:
    """Axis sizes, this rank's coordinate and the groups over the axes.

    ``dims``: sizes in ``axis_names`` order (default ``AXES``; a
    multi-slice mesh puts ``dcn`` first). ``rank``: this process's global
    rank (default: the world's). Groups are made when a process group of
    ``size`` ranks is up; otherwise (a layout, or a world of one process)
    every group is a list of ranks with no process group."""

    def __init__(self, dims, rank=None, build_groups=True, axis_names=AXES):
        from .env import get_rank
        self.axis_names = tuple(axis_names)
        self.dims = tuple(int(d) for d in dims)
        self.shape = dict(zip(self.axis_names, self.dims))
        self.size = _prod(self.dims)
        self._coords = list(itertools.product(*[range(d)
                                                for d in self.dims]))
        self.rank = (get_rank() if rank is None else int(rank)) % self.size
        self.coord = dict(zip(self.axis_names, self._coords[self.rank]))
        self._groups = {}
        if build_groups:
            self._build_groups()

    @property
    def data_axes(self):
        """The axes a batch's rows are split over and gradients averaged
        over: dcn (when the mesh has it), dp and sharding."""
        return (("dcn",) if "dcn" in self.shape else ()) + DATA_AXES

    @property
    def hybrid_dims(self):
        """The topology's dims (data, pipe, sharding, sep, model): dcn
        folded into data."""
        return (self.shape.get("dcn", 1) * self.shape["dp"],) + tuple(
            self.shape[a] for a in AXES[1:])

    def comm_lists(self, axes):
        """The rank lists that vary only along ``axes`` (every other
        coordinate fixed), sorted by that fixed coordinate."""
        idx = [self.axis_names.index(a) for a in axes]
        groups = {}
        for r, c in enumerate(self._coords):
            key = tuple(v for i, v in enumerate(c) if i not in idx)
            groups.setdefault(key, []).append(r)
        return [sorted(v) for _, v in sorted(groups.items())]

    def _build_groups(self):
        import torch.distributed as dist

        from .collective import Group, new_group
        live = dist.is_initialized() and dist.get_world_size() == self.size
        keys = [(a,) for a in self.axis_names] + [DATA_AXES, _CHECK_AXES]
        if "dcn" in self.shape:
            keys += [("dcn", "dp"), self.data_axes]
        for axes in keys:
            for ranks in self.comm_lists(axes):
                # every rank makes every group, in this order
                if live and len(ranks) > 1:
                    g = new_group(ranks)
                else:
                    g = Group(ranks, None)
                g.name = "+".join(axes)
                if self.rank in ranks:
                    self._groups[axes] = g

    def group(self, *axes):
        """The group of this rank along ``axes`` (one axis, or several:
        ``group("dp", "sharding")``)."""
        key = tuple(axes)
        if key not in self._groups:
            key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]

    def degree(self, *axes):
        return _prod(self.shape.get(a, 1) for a in axes)

    def axis_rank(self, *axes):
        """This rank's index in ``group(*axes)``."""
        return self.group(*axes).ranks.index(self.rank)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def build_mesh(dp=1, pp=1, sharding=1, sep=1, mp=1, devices=None, dcn_dp=1):
    """A mesh over ``devices`` ranks (a count or a list; default: the
    world), its groups made when that is the live world."""
    from .env import get_world_size
    n = get_world_size() if devices is None else (
        int(devices) if isinstance(devices, int) else len(list(devices)))
    degrees = {"dp": dp, "pp": pp, "sharding": sharding, "sep": sep, "mp": mp}
    dcn_dp = int(dcn_dp)
    total = _prod(degrees.values()) * dcn_dp
    if total != n:
        # absorb the remainder into dp (reference: leftover becomes dp)
        rem = n // max(total // max(dp, 1), 1)
        degrees["dp"] = max(rem, 1)
        total = _prod(degrees.values()) * dcn_dp
        if total != n:
            raise ValueError(
                f"mesh degrees {degrees} x dcn_dp={dcn_dp} do not multiply "
                f"to {n} devices")
    if dcn_dp > 1:
        return Mesh([dcn_dp] + [degrees[a] for a in AXES],
                    axis_names=("dcn",) + AXES)
    return Mesh([degrees[a] for a in AXES])


def set_default_mesh(mesh):
    global _default_mesh
    _default_mesh = mesh
    return mesh


def get_default_mesh():
    """The default mesh; made over the world as pure dp on first use."""
    global _default_mesh
    if _default_mesh is None:
        from .env import get_world_size
        _default_mesh = build_mesh(dp=get_world_size())
    return _default_mesh


def peek_default_mesh():
    """The default mesh if one was set; never makes one."""
    return _default_mesh


def mesh_batch_axes(mesh):
    """The mesh axes a data batch shards over (size > 1 dp/sharding
    axes). Empty: every process feeds the same batch."""
    return tuple(a for a in DATA_AXES if mesh.shape.get(a, 1) > 1)


def data_rank_world(mesh=None):
    """(this rank's index, count) over the data axes: what a batch sampler
    shards by. Without a mesh, the world's."""
    from .env import get_rank, get_world_size
    mesh = mesh if mesh is not None else peek_default_mesh()
    if mesh is None:
        return get_rank(), get_world_size()
    return mesh.axis_rank(*mesh.data_axes), mesh.degree(*mesh.data_axes)


def process_local_batch(value, mesh=None, spec=None, global_batch=None,
                        batch_dim=0):
    """This process's rows of the global batch, as a tensor on its rank.

    The global batch is the data ranks' rows in rank order; a rank already
    holds its own, so nothing moves. With ``global_batch`` defaulted in a
    multi-process run every process must feed the same number of rows: a
    ragged batch raises ``ValueError`` naming every process's count (one
    small all-gather per call, unconditional, as in the reference)."""
    from ..ops.dispatch import unwrap
    t = unwrap(value)
    mesh = mesh if mesh is not None else get_default_mesh()
    axes = mesh_batch_axes(mesh)
    if spec is None and not axes:
        raise ValueError(
            "mesh has no data-parallel axis (dp/sharding all size 1); "
            "per-process row concatenation is meaningless here — feed "
            "identical full batches on every process via "
            "replicated_batch(), or pass spec/global_batch explicitly")
    n_procs = mesh.size
    if global_batch is None and n_procs > 1:
        from . import collective
        counts = []
        collective.all_gather_object(counts, int(t.shape[batch_dim]))
        if len(set(counts)) > 1:
            raise ValueError(
                "process_local_batch: per-process row mismatch — "
                f"processes fed {counts} rows on batch_dim {batch_dim}, "
                "but with global_batch defaulted every process must feed "
                "the SAME number of rows (the global batch is local_rows x "
                "process_count). Pad or drop the ragged final batch "
                "(DataLoader(drop_last=True); Model.fit forces this), or "
                "pass global_batch explicitly.")
    tile = mesh.degree(*axes) if axes else 1
    gb = global_batch if global_batch is not None else \
        t.shape[batch_dim] * tile
    if gb % tile:
        raise ValueError(
            f"global batch {gb} does not tile the mesh batch axes {axes} "
            f"(x{tile}); pad or drop the ragged final batch (Model.fit "
            "does this automatically with drop_last)")
    return t


def sep_local_batch(value, mesh=None, seq_dim=1):
    """This rank's chunk of ``value`` along the sequence: the sep ranks
    share the batch's rows (``process_local_batch``'s, over the data axes)
    and rank i of the sep group keeps chunk i of sep equal chunks, the
    explicit-rank form of the reference's ``P("dp", "sep")`` input
    sharding. A sequence that does not split raises ``ValueError``; a mesh
    without a sep axis returns ``value``."""
    from ..ops.dispatch import unwrap
    t = unwrap(value)
    mesh = mesh if mesh is not None else get_default_mesh()
    n = mesh.shape["sep"]
    if n == 1:
        return t
    s = t.shape[seq_dim]
    if s % n:
        raise ValueError(
            f"sep_local_batch: sequence length {s} on dim {seq_dim} does "
            f"not split over the sep degree {n}; pad the sequence to a "
            f"multiple of {n} (of {2 * n} for the zigzag ring schedule)")
    return t.narrow(seq_dim, mesh.axis_rank("sep") * (s // n), s // n)


def replicated_batch(value, mesh=None):
    """``value``, which every process must hold identically (eval,
    predict, or a mesh with no data axis); a rank whose batch differs
    raises ``ValueError``."""
    import hashlib

    from . import collective
    from ..ops.dispatch import unwrap
    t = unwrap(value)
    mesh = mesh if mesh is not None else get_default_mesh()
    if mesh.size > 1:
        digest = hashlib.sha256(
            t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
            .numpy().tobytes()).hexdigest()
        seen = []
        collective.all_gather_object(seen, (tuple(t.shape), digest))
        if len(set(seen)) > 1:
            raise ValueError("replicated_batch: the processes hold "
                             f"different batches: {seen}")
    return t


def dcn_grad_sync(value, mesh=None, quant=None, op="mean", async_op=False):
    """This rank's gradient ``value`` reduced over the mesh's dcn group:
    "mean" (the default) or "sum". With a ``comm_quant`` config (a
    ``QuantConfig``, a dict, or True for the active one) it runs
    ``comm_quant.quantized_all_reduce`` over "dcn", so only codes and
    scales cross; otherwise an fp32 all-reduce (SUM, then / n for
    "mean"). A mesh without a dcn axis, or with dcn 1, returns ``value``.
    ``async_op=True`` returns a comm-plane work whose ``result()`` is the
    synced tensor (completed at once without a dcn axis; the quantized
    ring runs on the caller's thread and returns completed)."""
    from . import comm_plane
    from . import comm_quant as cq
    from .collective import ReduceOp
    from ..ops.dispatch import unwrap
    t = unwrap(value)
    mesh = mesh if mesh is not None else get_default_mesh()
    n = mesh.shape.get("dcn", 1)
    if n <= 1:
        if async_op:
            return comm_plane.CollectiveWork("dcn_grad_sync:no-dcn-axis",
                                             result=t)
        return t
    cfg = cq.resolve_config(quant)
    group = mesh.group("dcn")
    if cfg is None:
        work = comm_plane.async_all_reduce(
            t.detach().clone(), group,
            ReduceOp.AVG if op == "mean" else ReduceOp.SUM,
            label="dcn_grad_sync", span="comm_plane.dcn_sync", quant="fp32")
        return work if async_op else work.result()
    if async_op:
        return comm_plane.get_plane().run_inline(
            lambda: cq.quantized_all_reduce(t, group, cfg, op=op),
            "dcn_grad_sync")
    return cq.quantized_all_reduce(t, group, cfg, op=op)


# -- placements: which piece of the global tensor a rank holds ---------------
class Placement:
    """Where a rank's tensor sits in the global one: ``global_shape``,
    ``pieces`` [(local index, global index)], each index one (start, stop)
    per dimension (a TP qkv weight is three pieces: one column range of
    each of q, k and v), ``axes``, the mesh axes it is split over, and
    ``dim_axes``, those axes by the dimension they split, in the order
    they were applied (a stacked pipeline leaf under ZeRO: dimension 0
    over ``("pp", "sharding")``, its trailing one over ``("mp",)``). On
    every other axis the tensor is replicated, and the rank at coordinate
    0 of each such axis is the one that writes it to a checkpoint."""

    __slots__ = ("global_shape", "pieces", "axes", "dim_axes")

    def __init__(self, global_shape, pieces, axes=(), dim_axes=None):
        self.global_shape = tuple(int(s) for s in global_shape)
        self.pieces = [(tuple(tuple(p) for p in lo), tuple(tuple(p)
                                                           for p in gl))
                       for lo, gl in pieces]
        self.axes = tuple(axes)
        self.dim_axes = tuple(tuple(a) for a in dim_axes) \
            if dim_axes is not None else ((),) * len(self.global_shape)

    @classmethod
    def whole(cls, shape):
        idx = tuple((0, int(s)) for s in shape)
        return cls(shape, [(idx, idx)], ())

    def writer(self, mesh):
        """True when this rank writes the tensor: coordinate 0 on every
        axis the tensor is replicated over."""
        if mesh is None:
            return True
        return all(mesh.coord[a] == 0 for a in mesh.axis_names
                   if a not in self.axes)

    def narrow(self, dim, lo, hi, axis):
        """The placement of [lo, hi) of dimension ``dim`` of this rank's
        tensor, that dimension split over ``axis`` as well."""
        pieces = []
        for li, gi in self.pieces:
            a, b = max(li[dim][0], lo), min(li[dim][1], hi)
            if a >= b:
                continue
            off = gi[dim][0] - li[dim][0]
            pieces.append((li[:dim] + ((a - lo, b - lo),) + li[dim + 1:],
                           gi[:dim] + ((a + off, b + off),) + gi[dim + 1:]))
        dim_axes = list(self.dim_axes)
        dim_axes[dim] += (axis,)
        return Placement(self.global_shape, pieces, self.axes + (axis,),
                         dim_axes)

    def rows(self, lo, hi, axis):
        """The placement of rows [lo, hi) of dimension 0 of this tensor
        (a ZeRO shard), split over ``axis`` as well."""
        return self.narrow(0, lo, hi, axis)

    def take(self, full):
        """This rank's tensor cut out of the global ``full`` (a numpy array
        or a tensor)."""
        shape = [0] * len(self.global_shape)
        for li, _ in self.pieces:
            for d, (_, hi) in enumerate(li):
                shape[d] = max(shape[d], hi)
        if hasattr(full, "new_empty"):
            out = full.new_empty(shape)
        else:
            import numpy as np
            out = np.empty(shape, dtype=full.dtype)
        for li, gi in self.pieces:
            out[tuple(slice(*p) for p in li)] = \
                full[tuple(slice(*p) for p in gi)]
        return out

    def __repr__(self):
        return (f"Placement({self.global_shape}, axes={self.axes}, "
                f"pieces={self.pieces})")


def split_placement(shape, dim, parts, index, packed=1, axis="mp"):
    """The placement of piece ``index`` of ``parts`` of a tensor of global
    ``shape`` split along ``dim``; with ``packed`` > 1 the dimension is
    ``packed`` equal blocks (a fused qkv's q, k and v) and the piece takes
    its share of each block."""
    shape = tuple(int(s) for s in shape)
    block = shape[dim] // packed
    w = block // parts
    if block % parts or shape[dim] % packed:
        raise ValueError(f"dimension {dim} of {shape} does not split into "
                         f"{packed} blocks of {parts} pieces")
    pieces = []
    for b in range(packed):
        lo = tuple((0, s) for s in shape[:dim])
        hi = tuple((0, s) for s in shape[dim + 1:])
        g0 = b * block + index * w
        pieces.append((lo + ((b * w, (b + 1) * w),) + hi,
                       lo + ((g0, g0 + w),) + hi))
    dim_axes = [()] * len(shape)
    dim_axes[dim] = (axis,)
    return Placement(shape, pieces, (axis,), dim_axes)


def placement_of(t):
    """The tensor's placement, or None (a whole, replicated tensor)."""
    return getattr(t, "_placement", None)


def place(t, placement):
    """Attach ``placement`` to ``t`` (a parameter or a state tensor)."""
    t._placement = placement
    return t


def gather_global(t, placement=None):
    """The global tensor on the host, from every rank's piece of it (its
    ``placement``, default ``t``'s; a whole tensor is returned as it is).
    Every rank must call it; one all-gather of host arrays."""
    from . import collective
    placement = placement if placement is not None else placement_of(t)
    t = t.detach().cpu()
    if placement is None:
        return t.clone()
    seen = []
    collective.all_gather_object(seen, (placement.pieces, t))
    out = torch.empty(placement.global_shape, dtype=t.dtype)
    filled = torch.zeros(placement.global_shape, dtype=torch.bool)
    for pieces, local in seen:
        for li, gi in pieces:
            g = tuple(slice(*p) for p in gi)
            out[g] = local[tuple(slice(*p) for p in li)]
            filled[g] = True
    if not bool(filled.all()):
        raise ValueError("gather_global: the ranks' pieces do not cover "
                         f"{placement.global_shape}")
    return out
