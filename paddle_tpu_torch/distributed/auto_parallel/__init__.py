"""The semi-auto parallel API of the port (counterpart:
``paddle_tpu/distributed/auto_parallel/__init__.py``; upstream
``python/paddle/distributed/auto_parallel/``): ``ProcessMesh``, the
placements, ``shard_tensor``/``reshard``/``shard_layer``/
``unshard_dtensor``, ``Engine`` (``DistModel``, ``to_static``) and
``shard_dataloader``.

The reference's placed tensor is one global ``jax.Array`` laid out by a
``NamedSharding``, and GSPMD computes the same function whatever the
layout. The port has one process per rank, so a placed tensor is **this
rank's piece** of the global value, carrying ``_dist_attr = (mesh,
placements)`` and the piece's ``sharding_api.Placement`` (``_placement``),
which ``sharding_api.gather_global`` and ``distributed.checkpoint`` read:

- ``ProcessMesh(mesh, dim_names)``: the ids are the world's ranks (one
  process per rank, as ``sharding_api.Mesh`` has it) and are validated as
  the reference validates devices. Each mesh dimension has one
  ``torch.distributed`` group per line of ranks along it (the ranks that
  differ only in that coordinate), made on every rank in one order,
  including the lines a rank is not on, and shared by meshes over the same
  line. The reference's ``get_jax_mesh`` has no counterpart: the port's
  replacement is ``group(dim_name)``, this rank's group along a dimension.
- A dimension split over several mesh dimensions is split in mesh order
  (the outer mesh dimension is the major index), as ``_to_partition_spec``
  orders them. Pieces are equal: a dimension that does not divide raises
  ``ValueError``.
- ``shard_tensor(data, ...)`` is called on every rank with the same whole
  value, which the reference's single controller guarantees, and keeps the
  rank's piece. Given a layer's ``torch.nn.Parameter`` it places that
  parameter **in place** (``.data`` becomes the piece) and returns it, so
  ``layer.weight = dist.shard_tensor(layer.weight, mesh, [Shard(1)])`` and
  a bare ``dist.shard_tensor(layer.weight, ...)`` both leave the layer and
  its optimizer holding the placed parameter: the port's counterpart of
  the reference's ``p._value = dist.shard_tensor(...)._value``.
- ``reshard`` changes placements with collectives on the mesh's groups:
  Shard to Replicate is an all-gather, Replicate to Shard a local slice,
  Shard(i) to Shard(j) on one mesh dimension an all-to-all; a nested split
  (two mesh dimensions on one tensor dimension) that changes, and a move
  onto another ``ProcessMesh`` over the same ranks, gather the whole value
  and slice it.
- ``Partial`` is refused by ``shard_tensor`` and ``reshard``, as in the
  reference.

``Engine`` computes with placed parameters by gathering them whole at the
start of each step: one flat all-gather per mesh dimension for all of
them (the generalisation of ZeRO-3's ``_GatherParam`` to ``Shard(d)`` over
any mesh dimensions, done once a step rather than per attribute access),
then the forward runs through ``torch.func.functional_call`` with the
whole values, so a tied parameter is one leaf with both uses. The batch is
split over the mesh's first dimension when its rows divide (else
replicated), so every rank differentiates its rows' mean loss; the global
gradient is the mean over that dimension's ranks. A parameter split over
that dimension gets its piece by one flat reduce-scatter (AVG) of the
whole gradients along its split, then a local slice for its other splits;
every other gradient is sliced to its piece locally and averaged in one
flat all-reduce. The gradients are averaged exactly once, and nothing
else averages them: the ``Engine`` sets no default mesh and does not run
``CompiledTrainStep``. ``ClipGradByGlobalNorm`` takes each piece's square
sum, summed over the mesh dimensions that split it (one all-reduce of the
per-tensor sums per such dimension), so replicated tensors count once.
The optimizer updates each rank's piece (AdamW is elementwise). The loss
is assumed to be a mean over the batch's rows, as ``DataParallel``
assumes. ``fit``'s history and ``evaluate``'s loss are the global loss
(the ranks' losses averaged over the first mesh dimension, once per epoch
or call), the same on every rank; ``predict`` all-gathers the global
output onto every rank. ``save`` gathers the whole state (every rank must
call it) and the mesh's first rank writes ``.pdparams``/``.pdopt``;
``load`` reads the whole state and keeps each rank's pieces. ``Engine``
runs at O0 (no cast), as the reference's does.

``stats()`` counts the collectives this module issues and the bytes each
rank puts into them.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch

__all__ = [
    "ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
    "shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
    "unshard_dtensor", "Engine", "to_static",
]


# -- placements --------------------------------------------------------------

class Placement:
    """Base class (reference ``paddle.distributed.Placement``)."""

    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    """Tensor dim ``dim`` split along this mesh dimension."""

    def __init__(self, dim):
        self.dim = int(dim)

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))


class Replicate(Placement):
    def is_replicated(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("Replicate")


class Partial(Placement):
    """Pending reduction along this mesh dimension (API-compat marker).

    As in the reference, whose committed global arrays cannot hold a
    pending sum, ``shard_tensor`` and ``reshard`` refuse it; the port's
    ``Engine`` keeps its pending sums (the gradients) to itself."""

    def __init__(self, reduce_type="sum"):
        if reduce_type != "sum":
            raise NotImplementedError(
                f"Partial reduce_type {reduce_type!r}: only 'sum'")
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return "Partial()"

    def __eq__(self, other):
        return isinstance(other, Partial)

    def __hash__(self):
        return hash("Partial")


def _refuse_partial(placements):
    if any(isinstance(pl, Partial) for pl in placements):
        raise NotImplementedError(
            "Partial placements are unrepresentable on committed global "
            "arrays (see Partial docstring)")


# -- ProcessMesh -------------------------------------------------------------

_LINE_GROUPS = {}   # sorted ranks of a line -> Group (made once, in order)


def _line_group(ranks):
    from .. import collective
    key = tuple(sorted(ranks))
    if key not in _LINE_GROUPS:
        live = torch.distributed.is_initialized() and len(key) > 1
        _LINE_GROUPS[key] = collective.new_group(list(key)) if live \
            else collective.Group(list(key), None)
    return _LINE_GROUPS[key]


class ProcessMesh:
    """N-D logical mesh of ranks (reference ``dist.ProcessMesh``).

    ``mesh`` lists GLOBAL rank ids in shape order, ``dim_names`` names the
    dims. ``rank`` is this process's rank, ``coord`` its coordinate by dim
    name (None off the mesh); ``group(name)`` is its group along a dim."""

    def __init__(self, mesh, dim_names=None, shape=None, process_ids=None):
        from ..env import get_rank, get_world_size
        arr = np.asarray(mesh, dtype=np.int64)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(
                f"{len(dim_names)} dim_names for a {arr.ndim}-D mesh")
        self._shape = list(arr.shape)
        self._dim_names = [str(n) for n in dim_names]
        self._process_ids = arr.reshape(-1).tolist()
        world = get_world_size()
        if len(self._process_ids) > world:
            raise ValueError(
                f"mesh wants {len(self._process_ids)} ranks, have "
                f"{world} devices")
        if len(set(self._process_ids)) != len(self._process_ids):
            raise ValueError("duplicate rank ids in mesh")
        bad = [r for r in self._process_ids if not (0 <= r < world)]
        if bad:
            raise ValueError(f"rank ids {bad} out of range [0, {world})")
        self.rank = get_rank()
        where = np.argwhere(arr == self.rank)
        self._coord = tuple(int(c) for c in where[0]) if len(where) \
            else None
        self.axis_names = tuple(self._dim_names)
        self.coord = {n: (self._coord[i] if self._coord else None)
                      for i, n in enumerate(self._dim_names)}
        # every rank makes every line's group, in one order
        self._lines, self._groups = [], []
        for k in range(arr.ndim):
            lines = np.moveaxis(arr, k, -1).reshape(-1, arr.shape[k])
            mine, group = None, None
            for line in lines.tolist():
                g = _line_group(line)
                if self.rank in line:
                    mine, group = line, g
            self._lines.append(mine)
            self._groups.append(group)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return list(self._process_ids)

    @property
    def mesh(self):
        return np.asarray(self._process_ids).reshape(self._shape)

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def _dim(self, dim):
        return dim if isinstance(dim, int) else self._dim_names.index(dim)

    def group(self, dim):
        """This rank's group along ``dim`` (a name or an index): the
        port's replacement for the reference's ``get_jax_mesh``."""
        return self._groups[self._dim(dim)]

    def line(self, dim):
        """The ranks of this rank's group along ``dim``, in mesh order."""
        return self._lines[self._dim(dim)]

    def _member(self):
        if self._coord is None:
            raise ValueError(f"rank {self.rank} is not in {self!r}")
        return self._coord

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._shape == other._shape
                and self._process_ids == other._process_ids)

    def __repr__(self):
        return (f"ProcessMesh(shape={self._shape}, "
                f"dim_names={self._dim_names})")


# -- a placed tensor's layout --------------------------------------------------

class _Layout:
    """Where this rank's piece sits: for each tensor dim, the mesh dims
    that split it (mesh order), and the piece's (start, stop) per dim."""

    def __init__(self, mesh, placements, shape):
        placements = list(placements)
        if len(placements) != mesh.ndim:
            raise ValueError(
                f"{len(placements)} placements for a {mesh.ndim}-D mesh")
        self.mesh, self.placements = mesh, placements
        self.shape = tuple(int(s) for s in shape)
        ndim = len(self.shape)
        self.splits = [[] for _ in range(ndim)]
        for k, pl in enumerate(placements):
            if isinstance(pl, Shard):
                d = pl.dim if pl.dim >= 0 else pl.dim + ndim
                if not (0 <= d < ndim):
                    raise ValueError(f"Shard dim {pl.dim} out of range")
                self.splits[d].append(k)
            elif not isinstance(pl, (Replicate, Partial)):
                raise TypeError(f"not a Placement: {pl!r}")
        for d, ks in enumerate(self.splits):
            n = math.prod(mesh.shape[k] for k in ks)
            if self.shape[d] % n:
                raise ValueError(
                    f"dimension {d} of {self.shape} does not split into "
                    f"{n} equal pieces over mesh dims "
                    f"{[mesh.dim_names[k] for k in ks]}")
        self.split_dims = sorted(k for ks in self.splits for k in ks)

    def span(self, d, ks, extent):
        """(start, stop) of this rank's piece along tensor dim ``d`` of a
        tensor whose extent there is ``extent``, split over mesh dims
        ``ks`` (a suffix of ``splits[d]``)."""
        coord = self.mesh._member()
        idx, n = 0, 1
        for k in ks:
            idx = idx * self.mesh.shape[k] + coord[k]
            n *= self.mesh.shape[k]
        w = extent // n
        return idx * w, (idx + 1) * w

    def placement(self):
        """The piece as a ``sharding_api.Placement``."""
        from ..sharding_api import Placement as Pieces
        gl = tuple(self.span(d, ks, s) if ks else (0, s)
                   for d, (s, ks) in enumerate(zip(self.shape, self.splits)))
        lo = tuple((0, b - a) for a, b in gl)
        axes = tuple(self.mesh.dim_names[k] for k in self.split_dims)
        return Pieces(self.shape, [(lo, gl)], axes)

    def only(self, dims):
        """This layout with only its splits over the mesh dims ``dims``
        (the others already applied, or not to apply)."""
        out = copy.copy(self)
        out.splits = [[k for k in ks if k in dims] for ks in self.splits]
        out.split_dims = sorted(k for ks in out.splits for k in ks)
        return out

    def slice(self, t):
        """``t`` cut to this rank's piece along every split."""
        for d, ks in enumerate(self.splits):
            if ks:
                a, b = self.span(d, ks, t.shape[d])
                t = t.narrow(d, a, b - a)
        return t


def _layout_of(t):
    return getattr(t, "_layout", None)


def _attach(t, layout):
    """Mark ``t`` (a tensor, a Parameter or a paddle Tensor) as placed."""
    t._layout = layout
    t._dist_attr = (layout.mesh, list(layout.placements))
    t._placement = layout.placement()
    return t


# -- the collectives -----------------------------------------------------------

_STATS = {"collectives": 0, "bytes": 0}


def stats():
    """{'collectives', 'bytes'}: the collectives this module issued and
    the bytes this rank put into them, since the last ``reset_stats``."""
    return dict(_STATS)


def reset_stats():
    _STATS.update(collectives=0, bytes=0)


def _count(t):
    _STATS["collectives"] += 1
    _STATS["bytes"] += t.numel() * t.element_size()


def _mesh_order(mesh, k, items):
    """``items`` (one per group rank, in the group's order) in mesh
    order along dim ``k``."""
    g = mesh.group(k)
    return [items[g.ranks.index(r)] for r in mesh.line(k)]


def _group_order(mesh, k, items):
    """``items`` (one per mesh coordinate along ``k``) in the group's
    order."""
    line = mesh.line(k)
    return [items[line.index(r)] for r in mesh.group(k).ranks]


def _by_dtype(entries):
    out = {}
    for e in entries:
        out.setdefault(e[1].dtype, []).append(e)
    return list(out.values())


def _gather_whole(tensors, layouts):
    """The whole values of placed pieces (no autograd): for each mesh dim,
    innermost first, one flat all-gather per dtype of every piece split
    over it, concatenated in mesh order along its tensor dim."""
    from .. import comm_plane
    cur = [t.detach() for t in tensors]
    if not layouts:
        return cur
    mesh = layouts[0].mesh
    for k in reversed(range(mesh.ndim)):
        n = mesh.shape[k]
        todo = [(i, cur[i], next(d for d, ks in enumerate(lay.splits)
                                 if k in ks))
                for i, lay in enumerate(layouts) if k in lay.split_dims]
        if n == 1 or not todo:
            continue
        for group in _by_dtype(todo):
            flat = torch.cat([t.contiguous().reshape(-1)
                              for _, t, _ in group])
            outs = [torch.empty_like(flat) for _ in range(n)]
            _count(flat)
            comm_plane.async_all_gather(
                outs, flat, mesh.group(k), label="auto_parallel.gather",
                span="auto_parallel.all_gather").wait()
            outs = _mesh_order(mesh, k, outs)
            off = 0
            for i, t, d in group:
                m = t.numel()
                cur[i] = torch.cat([o[off:off + m].view(t.shape)
                                    for o in outs], dim=d)
                off += m
    return cur


# -- shard_tensor / reshard / shard_layer --------------------------------------

def _raw_value(data, dtype=None):
    from ...ops.dispatch import unwrap
    t = unwrap(data)
    if dtype is not None:
        from ...framework.dtype import to_torch_dtype
        t = t.to(to_torch_dtype(dtype))
    return t


def _wrap_like(data, piece):
    """``piece`` as the kind of tensor ``data`` is (a paddle Tensor stays
    one; anything else becomes a torch tensor)."""
    from ...tensor import Tensor
    if isinstance(data, Tensor):
        return Tensor._wrap(piece)
    return piece


def _place_parameter(p, piece, layout):
    with torch.no_grad():
        p.data = piece.contiguous().clone()
    return _attach(p, layout)


def shard_tensor(data, mesh: ProcessMesh, placements, dtype=None,
                 stop_gradient=None):
    """This rank's piece of ``data`` placed on the mesh (reference
    ``dist.shard_tensor``). Every rank passes the same whole value. A
    ``torch.nn.Parameter`` is placed in place and returned; a placed
    tensor is resharded."""
    _refuse_partial(placements)
    if _layout_of(data) is not None:
        return reshard(data, mesh, placements)
    t = _raw_value(data, dtype)
    layout = _Layout(mesh, placements, t.shape)
    piece = layout.slice(t.detach())
    if isinstance(data, torch.nn.Parameter):
        return _place_parameter(data, piece, layout)
    piece = piece.contiguous().clone()
    if stop_gradient is not None and piece.is_floating_point():
        piece.requires_grad_(not stop_gradient)
    elif t.requires_grad:
        piece.requires_grad_(True)
    out = _wrap_like(data, piece)
    _attach(piece, layout)
    return out if out is piece else _attach(out, layout)


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    """reference ``dist.dtensor_from_fn``: build then place."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def _all_to_all(t, mesh, k, split_dim, concat_dim):
    """Shard(concat_dim) -> Shard(split_dim) over mesh dim ``k``: chunk
    j of ``t`` along ``split_dim`` goes to mesh coordinate j, and the
    received chunks are concatenated in mesh order along ``concat_dim``."""
    from ..sep_transport import all_to_all
    n = mesh.shape[k]
    chunks = _group_order(mesh, k, list(t.chunk(n, split_dim)))
    _count(t)
    out = all_to_all([torch.cat(chunks, split_dim).contiguous()],
                     mesh.group(k), split_dim, concat_dim,
                     label="auto_parallel.all_to_all")[0]
    got = _mesh_order(mesh, k, list(out.chunk(n, concat_dim)))
    return torch.cat(got, concat_dim)


def _dim_of(lay, k):
    """The tensor dim mesh dim ``k`` splits under ``lay``, or None."""
    return next((d for d, ks in enumerate(lay.splits) if k in ks), None)


def _stepwise(src, dst):
    """True when ``src`` -> ``dst`` can go one mesh dim at a time: one
    mesh dim a tensor dim on both sides, and an all-to-all's tensor dims
    split by no other mesh dim before or after."""
    if src.mesh != dst.mesh or any(len(ks) > 1
                                   for ks in src.splits + dst.splits):
        return False
    for k in range(src.mesh.ndim):
        a, b = _dim_of(src, k), _dim_of(dst, k)
        if a is not None and b is not None and a != b and (
                src.splits[b] or dst.splits[a]):
            return False
    return True


def _reshard_value(t, src, dst):
    """The piece of ``t`` (placed by ``src``) under ``dst``."""
    if not _stepwise(src, dst):
        if sorted(src.mesh.process_ids) != sorted(dst.mesh.process_ids):
            raise NotImplementedError(
                "reshard between meshes over different ranks (a send from "
                "ranks that hold the value to ranks that do not) is not "
                "ported; reshard onto a mesh over the same ranks")
        return dst.slice(_gather_whole([t], [src])[0])
    mesh = src.mesh
    moves = [(k, _dim_of(src, k), _dim_of(dst, k))
             for k in range(mesh.ndim)]
    # Shard -> Replicate first, then Shard(i) -> Shard(j), then slices
    gone = [k for k, a, b in moves if a is not None and b is None]
    if gone:
        t = _gather_whole([t], [src.only(gone)])[0]
    for k, a, b in moves:
        if a is not None and b is not None and a != b:
            t = _all_to_all(t, mesh, k, b, a)
    for k, a, b in moves:
        if a is None and b is not None:
            lo, hi = dst.span(b, [k], t.shape[b])
            t = t.narrow(b, lo, hi - lo)
    return t.contiguous()


def reshard(tensor, mesh: ProcessMesh, placements):
    """Re-place a placed tensor onto ``placements`` of ``mesh``
    (reference ``dist.reshard``); a tensor that is not placed is taken as
    the whole value on every rank."""
    _refuse_partial(placements)
    src = _layout_of(tensor)
    if src is None:
        return shard_tensor(tensor, mesh, placements)
    raw = getattr(tensor, "_value", tensor)
    dst = _Layout(mesh, placements, src.shape)
    with torch.no_grad():
        piece = _reshard_value(raw.detach(), src, dst)
    if isinstance(tensor, torch.nn.Parameter):
        return _place_parameter(tensor, piece, dst)
    if raw.requires_grad:
        piece.requires_grad_(True)
    out = _wrap_like(tensor, piece)
    _attach(piece, dst)
    return out if out is piece else _attach(out, dst)


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """Place every parameter of ``layer`` on the mesh (reference
    ``dist.shard_layer``). ``shard_fn(name, layer, mesh)`` decides each
    sublayer's placements by calling ``shard_tensor`` on its parameters
    (in place); the default replicates everything. ``input_fn`` and
    ``output_fn`` wrap ``forward``."""
    if shard_fn is None:
        def shard_fn(name, sublayer, mesh):
            for p in sublayer.parameters(recurse=False):
                if _layout_of(p) is None:
                    shard_tensor(p, mesh,
                                 [Replicate() for _ in range(mesh.ndim)])

    for name, sub in layer.named_modules():
        shard_fn(name, sub, process_mesh)

    if input_fn is not None or output_fn is not None:
        orig_forward = layer.forward

        def wrapped(*args, **kwargs):
            if input_fn is not None:
                args = input_fn(args, process_mesh)
            out = orig_forward(*args, **kwargs)
            if output_fn is not None:
                out = output_fn(out, process_mesh)
            return out

        layer.forward = wrapped
    return layer


def unshard_dtensor(tensor):
    """The whole value of a placed tensor, not placed (reference
    ``dist.unshard_dtensor``); every rank of its mesh must call it."""
    lay = _layout_of(tensor)
    if lay is None:
        return tensor
    with torch.no_grad():
        whole = _gather_whole([getattr(tensor, "_value", tensor)], [lay])[0]
    return _wrap_like(tensor, whole.clone())


# -- Engine ------------------------------------------------------------------

def _mesh_of_params(params):
    meshes = []
    for p in params:
        lay = _layout_of(p)
        if lay is not None and lay.mesh not in meshes:
            meshes.append(lay.mesh)
    if len(meshes) > 1:
        raise ValueError(f"placed parameters on different meshes: {meshes}")
    return meshes[0] if meshes else None


class Engine:
    """Semi-auto-parallel trainer (reference ``auto_parallel.Engine`` with
    ``prepare/fit/evaluate/predict/save/load``); the module docstring
    says how it computes with placed parameters."""

    def __init__(self, model, loss=None, optimizer=None, metrics=None,
                 strategy=None, mesh: ProcessMesh | None = None):
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else (
            [metrics] if metrics is not None else [])
        self._strategy = strategy
        self._mesh = mesh
        self._ready = False
        self._history = None

    # -- set-up ----------------------------------------------------------------
    def _ensure_step(self):
        if self._ready:
            return
        named = list(self._model.named_parameters())
        pmesh = _mesh_of_params(p for _, p in named)
        if self._mesh is not None and pmesh is not None and \
                pmesh != self._mesh:
            raise ValueError(f"the parameters are placed on {pmesh}, the "
                             f"Engine's mesh is {self._mesh}")
        for m in (self._mesh, pmesh):
            if m is not None:
                m._member()
        self._placed = [(n, p) for n, p in named if _layout_of(p) is not None]
        self._trainable = [p for _, p in named if p.requires_grad]
        if self._optimizer is not None:
            self._cut_state()
        self._ready = True

    def _cut_state(self):
        """Optimizer state made for a whole parameter before it was
        placed, cut to the piece."""
        opt = self._optimizer
        for p in self._trainable:
            lay = _layout_of(p)
            accs = opt._accumulators.get(id(p))
            if lay is None or accs is None:
                continue
            for k, v in list(accs.items()):
                if torch.is_tensor(v) and tuple(v.shape) == lay.shape:
                    accs[k] = lay.slice(v).contiguous().clone()

    def _device(self):
        for p in self._model.parameters():
            return p.device
        return torch.device("cpu")

    def _place_batch(self, value):
        """(this rank's rows, whether they are a split of the batch): a
        field a ``ShardDataloader`` placed is already split; otherwise the
        batch is split over the mesh's first dim when its rows divide."""
        attr = getattr(value, "_dist_attr", None)
        raw = getattr(value, "_value", value)
        if not torch.is_tensor(raw):
            raw = torch.as_tensor(np.asarray(raw))
        raw = raw.to(self._device())
        if attr is not None:
            mesh, pls = attr
            if self._mesh is not None and mesh != self._mesh:
                raise ValueError(f"a batch placed on {mesh} fed to an "
                                 f"Engine on {self._mesh}")
            return raw, isinstance(pls[0], Shard) and pls[0].dim == 0
        if self._mesh is None or self._mesh.shape[0] == 1:
            return raw, False
        n = self._mesh.shape[0]
        if raw.ndim and raw.shape[0] % n == 0:
            w = raw.shape[0] // n
            return raw.narrow(0, self._mesh._member()[0] * w, w), True
        return raw, False

    @staticmethod
    def _as_batch_list(batch):
        """DataLoader yields a list of fields or a bare tensor (one-field
        datasets, the normal shape for predict)."""
        return list(batch) if isinstance(batch, (list, tuple)) else [batch]

    def _fields(self, batch):
        placed = [self._place_batch(b) for b in self._as_batch_list(batch)]
        return [t for t, _ in placed], any(s for _, s in placed)

    # -- the step --------------------------------------------------------------
    def _call(self, wholes, xs):
        subs = {n: w for (n, _), w in zip(self._placed, wholes)}
        if not subs:
            return self._model(*xs)
        return torch.func.functional_call(self._model, subs, tuple(xs))

    def _gather(self):
        return _gather_whole([p for _, p in self._placed],
                             [_layout_of(p) for _, p in self._placed])

    def _forward_backward(self, fields, split):
        """This rank's loss on its rows and the trainable parameters'
        gradients, each its parameter's piece of the global gradient
        (placed like the parameter)."""
        *xs, y = fields
        wholes = [w.requires_grad_(p.requires_grad) for w, (_, p) in
                  zip(self._gather(), self._placed)]
        leaf = {id(p): w for w, (_, p) in zip(wholes, self._placed)}
        targets = [leaf.get(id(p), p) for p in self._trainable]
        with torch.enable_grad():
            loss = self._loss(self._call(wholes, xs), y)
            if isinstance(loss, (tuple, list)):
                loss = loss[0]
            loss = loss.float()
            grads = torch.autograd.grad(loss, targets, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g.detach()
                 for g, t in zip(grads, targets)]
        grads = self._sync(grads, split)
        for g, p in zip(grads, self._trainable):
            if _layout_of(p) is not None:
                _attach(g, _layout_of(p))
        return loss.detach(), grads

    def _sync(self, grads, split):
        """Whole local gradients -> this rank's pieces of the global
        gradient: the mean over the batch's mesh dim when the batch is
        split there (reduce-scatter for pieces split over it, one flat
        all-reduce for the rest), local slices otherwise."""
        from .. import comm_plane
        from ..collective import ReduceOp
        mesh = self._mesh
        grads = list(grads)
        rs, ar = [], []
        for i, (p, g) in enumerate(zip(self._trainable, grads)):
            lay = _layout_of(p)
            if split and lay is not None and 0 in lay.split_dims:
                rs.append(i)
                continue
            if lay is not None:
                grads[i] = lay.slice(g)
            if split:
                ar.append(i)
        if rs:
            n = mesh.shape[0]
            for group in _by_dtype([(i, grads[i]) for i in rs]):
                rows, dims = [], []
                for i, g in group:
                    d = next(d for d, ks in
                             enumerate(_layout_of(self._trainable[i]).splits)
                             if 0 in ks)
                    dims.append(d)
                    rows.append(g.movedim(d, 0).reshape(n, -1))
                flat = torch.cat(rows, dim=1)
                flat = torch.stack(_group_order(mesh, 0, list(flat)))
                out = flat.new_empty(flat.shape[1])
                _count(flat)
                comm_plane.async_reduce_scatter(
                    out, flat.reshape(-1), mesh.group(0), ReduceOp.AVG,
                    label="auto_parallel.grad_rs",
                    span="auto_parallel.reduce_scatter").wait()
                off = 0
                for (i, g), d in zip(group, dims):
                    moved = g.movedim(d, 0)
                    shape = (moved.shape[0] // n,) + tuple(moved.shape[1:])
                    m = math.prod(shape)
                    block = out[off:off + m].view(shape).movedim(0, d)
                    off += m
                    lay = _layout_of(self._trainable[i])
                    grads[i] = lay.only(set(lay.split_dims) - {0}).slice(
                        block).contiguous()
        if ar and mesh.shape[0] > 1:
            for group in _by_dtype([(i, grads[i]) for i in ar]):
                flat = torch.cat([g.reshape(-1) for _, g in group])
                _count(flat)
                comm_plane.async_all_reduce(
                    flat, mesh.group(0), ReduceOp.AVG,
                    label="auto_parallel.grad_sync",
                    span="auto_parallel.all_reduce").wait()
                off = 0
                for i, g in group:
                    grads[i] = flat[off:off + g.numel()].view(g.shape)
                    off += g.numel()
        return grads

    def _square_sums(self, grads):
        """Each trainable tensor's whole-gradient square sum (fp32): the
        pieces' sums summed over the mesh dims that split them."""
        from ..collective import all_reduce
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in grads])
        lays = [_layout_of(p) for p in self._trainable]
        mesh = _mesh_of_params(self._trainable)
        if mesh is None:
            return sq
        for k in range(mesh.ndim):
            mask = torch.tensor([lay is not None and k in lay.split_dims
                                 for lay in lays], device=sq.device)
            if mesh.shape[k] == 1 or not bool(mask.any()):
                continue
            part = torch.where(mask, sq, torch.zeros_like(sq))
            _count(part)
            all_reduce(part, group=mesh.group(k))
            sq = torch.where(mask, part, sq)
        return sq

    def _clip(self, grads):
        from ...nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                ClipGradByValue)
        clip = getattr(self._optimizer, "_grad_clip", None)
        if clip is None:
            return grads
        if isinstance(clip, ClipGradByValue):
            return [torch.clamp(g, clip.min, clip.max) for g in grads]
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)):
            raise TypeError(f"unsupported grad clip in the Engine: {clip!r}")
        sq = self._square_sums(grads)
        if isinstance(clip, ClipGradByGlobalNorm):
            sq = torch.sum(sq).expand(len(grads))
        scale = torch.clamp(clip.clip_norm / torch.clamp(torch.sqrt(sq),
                                                         min=1e-12), max=1.0)
        return [(g.float() * s).to(g.dtype) for g, s in zip(grads, scale)]

    def _train_step(self, fields, split):
        loss, grads = self._forward_backward(fields, split)
        opt = self._optimizer
        with torch.no_grad():
            grads = self._clip(grads)
            lr = opt.get_lr()
            for p, g in zip(self._trainable, grads):
                opt._apply(p, g, lr)
        opt._step_count += 1
        return loss

    def _global_losses(self, losses, splits):
        """The steps' global losses (floats): split steps averaged over
        the batch's mesh dim, in one all-reduce."""
        from .. import comm_plane
        from ..collective import ReduceOp
        if not losses:
            return []
        vec = torch.stack(losses).float()
        if any(splits):
            avg = vec.clone()
            _count(avg)
            comm_plane.async_all_reduce(avg, self._mesh.group(0),
                                        ReduceOp.AVG,
                                        label="auto_parallel.loss").wait()
            vec = torch.where(torch.tensor(splits, device=vec.device), avg,
                              vec)
        return [float(x) for x in vec.cpu()]

    # -- the reference's surface -----------------------------------------------
    def _loader(self, data, batch_size, shuffle=False):
        from ...io import DataLoader, Dataset
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size or 1,
                              shuffle=shuffle)
        return data

    def prepare(self, *args, **kwargs):
        self._ensure_step()

    def fit(self, train_data, epochs=1, batch_size=None, steps_per_epoch=None,
            log_freq=10, verbose=0):
        """train_data: a Dataset, DataLoader or ShardDataloader yielding
        (inputs, label) batches. Returns a history dict of per-epoch mean
        global losses."""
        self._ensure_step()
        loader = self._loader(train_data, batch_size)
        history = {"loss": []}
        for ep in range(epochs):
            losses, splits = [], []
            for it, batch in enumerate(loader):
                if steps_per_epoch is not None and it >= steps_per_epoch:
                    break
                fields, split = self._fields(batch)
                losses.append(self._train_step(fields, split))
                splits.append(split)
            got = self._global_losses(losses, splits)
            history["loss"].append(
                float(np.mean(got)) if got else float("nan"))
        self._history = history
        return history

    @torch.no_grad()
    def evaluate(self, eval_data, batch_size=None, steps=None):
        self._ensure_step()
        loader = self._loader(eval_data, batch_size)
        losses, splits = [], []
        wholes = self._gather()
        for it, batch in enumerate(loader):
            if steps is not None and it >= steps:
                break
            fields, split = self._fields(batch)
            *xs, y = fields
            loss = self._loss(self._call(wholes, xs), y)
            losses.append((loss[0] if isinstance(loss, (tuple, list))
                           else loss).float())
            splits.append(split)
        got = self._global_losses(losses, splits)
        return {"loss": float(np.mean(got)) if got else float("nan")}

    @torch.no_grad()
    def predict(self, test_data, batch_size=None, steps=None):
        """The model's outputs on the first field of each batch, whole on
        every rank (a split batch's outputs all-gathered over the mesh's
        first dim)."""
        from .. import comm_plane
        self._ensure_step()
        loader = self._loader(test_data, batch_size)
        wholes = self._gather()
        outs = []
        for it, batch in enumerate(loader):
            if steps is not None and it >= steps:
                break
            fields, split = self._fields(batch)
            out = self._call(wholes, fields[:1])
            if split:
                mesh = self._mesh
                out = out.contiguous()
                parts = [torch.empty_like(out) for _ in range(mesh.shape[0])]
                _count(out)
                comm_plane.async_all_gather(
                    parts, out, mesh.group(0),
                    label="auto_parallel.predict").wait()
                out = torch.cat(_mesh_order(mesh, 0, parts), 0)
            outs.append(out)
        return outs

    def _writer(self):
        mesh = self._mesh or _mesh_of_params(self._trainable)
        return mesh is None or mesh.rank == mesh.process_ids[0]

    def _barrier(self):
        from ..collective import all_reduce
        mesh = self._mesh or _mesh_of_params(self._trainable)
        if mesh is None:
            return
        for k in range(mesh.ndim):
            if mesh.shape[k] > 1:
                all_reduce(torch.zeros(1, device=self._device()),
                           group=mesh.group(k))

    @torch.no_grad()
    def _whole_state(self):
        """(model state, optimizer state), every placed tensor whole."""
        placed = dict(self._placed)
        model = self._model.state_dict()
        opt = dict(self._optimizer.state_dict()) \
            if self._optimizer is not None else None
        todo = [(model, k, placed[k], _layout_of(placed[k]))
                for k in model if k in placed]
        if opt is not None:
            for pname, p in zip(self._optimizer._state_names(),
                                self._optimizer._parameters):
                lay = _layout_of(p)
                todo += [(opt, k, opt[k], lay) for k in opt
                         if lay is not None and k.startswith(pname + ".")
                         and torch.is_tensor(opt[k])
                         and tuple(opt[k].shape) == tuple(p.shape)]
        # one flat gather per mesh dim for all of them
        wholes = _gather_whole([t for _, _, t, _ in todo],
                               [lay for _, _, _, lay in todo])
        for (d, k, _, _), w in zip(todo, wholes):
            d[k] = w.clone()
        return model, opt

    def save(self, path):
        """``path.pdparams`` and ``path.pdopt``, whole; every rank of the
        mesh calls it, the mesh's first rank writes."""
        from ...framework.io import save
        self._ensure_step()
        model, opt = self._whole_state()
        if self._writer():
            save(model, path + ".pdparams")
            if opt is not None:
                save(opt, path + ".pdopt")
        self._barrier()

    @torch.no_grad()
    def load(self, path):
        """Read the whole state and keep this rank's pieces."""
        import os

        from ...framework.io import load
        self._ensure_step()
        state = load(path + ".pdparams", return_numpy=True)
        placed = dict(self._placed)
        for k, p in placed.items():
            if k in state:
                whole = torch.as_tensor(np.asarray(state.pop(k)))
                p.data.copy_(_layout_of(p).slice(whole))
        if state:
            self._model.set_state_dict(state)
        if self._optimizer is not None and os.path.exists(path + ".pdopt"):
            opt = load(path + ".pdopt", return_numpy=True)
            for pname, p in zip(self._optimizer._state_names(),
                                self._optimizer._parameters):
                lay = _layout_of(p)
                if lay is None:
                    continue
                for key in [k for k in opt if k.startswith(pname + ".")]:
                    v = opt[key]
                    if isinstance(v, np.ndarray) and v.shape == lay.shape:
                        opt[key] = lay.slice(torch.as_tensor(v)).numpy()
            self._optimizer.set_state_dict(opt)


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              mesh=None):
    """reference ``dist.to_static``: wrap a dygraph layer + loader into a
    distributed Engine-like object."""
    return Engine(layer, loss=loss, optimizer=optimizer, strategy=strategy,
                  mesh=mesh)


# ``dist.to_static`` upstream returns a DistModel; here the Engine plays
# that role (same prepare/fit surface), so the name binds to the same class.
DistModel = Engine


class ReduceType:
    """reference ``paddle.distributed.ReduceType`` constants (the
    partial-tensor reduction kinds Partial placements carry)."""

    kRedSum = 0
    kRedMax = 1
    kRedMin = 2
    kRedProd = 3
    kRedAvg = 4
    kRedAny = 5
    kRedAll = 6


class DistAttr:
    """reference ``paddle.distributed.DistAttr(mesh, sharding_specs)``:
    dim i of the tensor is sharded over the named mesh axis in
    ``sharding_specs[i]`` (None = replicated). ``placements`` lowers it to
    the Placement list ``shard_tensor`` consumes."""

    def __init__(self, mesh: ProcessMesh, sharding_specs):
        self.process_mesh = mesh
        self.sharding_specs = list(sharding_specs)

    def placements(self):
        # sharding_specs is indexed by TENSOR dim; the Placement list is
        # indexed by MESH dim and carries the tensor dim inside Shard
        out = [Replicate() for _ in self.process_mesh.dim_names]
        for tensor_dim, axis in enumerate(self.sharding_specs):
            if axis is None:
                continue
            out[self.process_mesh.dim_names.index(axis)] = Shard(tensor_dim)
        return out


def strategy_cls():
    from ..fleet.base.distributed_strategy import DistributedStrategy
    return DistributedStrategy


def __getattr__(name):
    # ``dist.Strategy`` is the to_static config container; fleet's
    # DistributedStrategy is that container here (Engine accepts either).
    # Resolved lazily to keep auto_parallel importable before fleet.
    if name == "Strategy":
        return strategy_cls()
    raise AttributeError(name)


class ShardDataloader:
    """reference ``dist.shard_dataloader`` result: iterates the wrapped
    loader, each batch field this rank's rows of it, split over
    ``meshes[0]``'s first dim when the rows divide (else whole), placed
    as ``[Shard(0), Replicate(), ...]`` so an ``Engine`` takes them as
    they are; ``input_keys`` selects dict fields."""

    def __init__(self, dataloader, meshes, input_keys=None,
                 shard_dims=None, is_dataset_splitted=False):
        self._loader = dataloader
        self._mesh = meshes[0] if isinstance(meshes, (list, tuple)) \
            else meshes
        self._input_keys = input_keys
        self._shard_dims = shard_dims

    def __len__(self):
        return len(self._loader)

    def _place(self, value):
        from ...ops.dispatch import unwrap
        mesh = self._mesh
        v = unwrap(value) if not isinstance(value, np.ndarray) else \
            torch.from_numpy(value)
        n = mesh.shape[0]
        if not (v.ndim and v.shape[0] % n == 0):
            return v
        pls = [Shard(0)] + [Replicate() for _ in range(mesh.ndim - 1)]
        return shard_tensor(v, mesh, pls)

    def __iter__(self):
        for batch in self._loader:
            if isinstance(batch, dict):
                yield {k: (self._place(v) if self._input_keys is None or
                           k in self._input_keys else v)
                       for k, v in batch.items()}
            elif isinstance(batch, (list, tuple)):
                yield [self._place(v) for v in batch]
            else:
                yield self._place(batch)


def shard_dataloader(dataloader, meshes, input_keys=None, shard_dims=None,
                     is_dataset_splitted=False):
    return ShardDataloader(dataloader, meshes, input_keys, shard_dims,
                           is_dataset_splitted)
