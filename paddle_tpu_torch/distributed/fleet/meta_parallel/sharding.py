"""ZeRO stages 1 to 3 over the sharding group (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel/sharding.py``; upstream
``fleet/meta_parallel/sharding/`` and ``sharding/group_sharded.py``).

The reference makes ZeRO a placement and lets XLA insert the
collectives; the port shards by hand over the mesh's sharding group, with
its own flat buffers and the comm plane (so the plane's stats see the
traffic), as ``DataParallel`` builds its own buckets:

- ``os`` (ZeRO-1): each rank keeps the optimizer state of its rows of
  each parameter, updates those rows from the all-reduced gradient, then
  the rows are all-gathered back into every rank's parameter.
- ``os_g`` (ZeRO-2): the same, with the gradients reduce-scattered onto
  the rows instead of all-reduced.
- ``p_g_os`` (ZeRO-3): parameters are stored as their rows. Reading one
  through its layer (``layer.weight``) all-gathers it, with a backward
  that reduce-scatters (averages) the gradient onto the rows; inside the
  ``GroupShardedStage3`` forward the whole value is not kept for the
  backward (a saved-tensor hook keeps the rows and gathers again when the
  backward needs it), so it is freed after use. ``get_all_parameters``
  gathers them back whole.

The partition rule is the reference's ``zero_partition_spec``: dimension
0 is split over the sharding axis, a tensor whose dimension 0 does not
divide is left whole (replicated), and the rule composes with TP and
the pipeline: the ZeRO rows are taken of the rank's TP piece, or of a
stacked leaf's stage rows and mp piece (``group_sharded_parallel``
commits the model's own placement first). A parameter's partition
(``p._zero``) and its optimizer state (the inner optimizer's
accumulators, rows-shaped) travel with the parameter and the inner
optimizer, so ``CompiledTrainStep`` given the unwrapped net and
``getattr(opt, "_optim", opt)`` runs ZeRO, as the reference's placements
travel with its arrays. ``sync_gradients``, ``hybrid_clip`` and
``sharded_update`` are the one home of the gradient average, the clip
and the update under a mesh: the train step, the ZeRO optimizer wrapper
and ``HybridParallelOptimizer`` call them.

``get_all_parameters(quant=None)`` gathers through
``comm_quant.quantized_replicate`` when a ``comm_quant`` config is active
(``fleet.init`` with ``strategy.comm_quant``) or given, so codes and
scales cross instead of fp32, and every parameter, sharded or not, comes
back as the decode of the whole value's encoding, as in the reference;
``quant=False`` forces the exact fp32 gather (a checkpoint must stay
bit-exact). The forward's gather-on-use stays fp32, as the reference's
GSPMD forward does.
"""
from __future__ import annotations

import weakref

import torch
import torch.distributed as dist

from ....nn.layer.layers import Layer
from ...sharding_api import Placement, get_default_mesh, placement_of, place

LEVELS = ("os", "os_g", "p_g_os")


class ZeroShard:
    """A parameter's ZeRO partition: rows [lo, hi) of dimension 0 of its
    (TP) piece of ``full_shape``, over ``group`` (``n`` ranks, this one at
    ``index``), at ``level``."""

    __slots__ = ("level", "group", "n", "index", "lo", "hi", "full_shape",
                 "full_placement")

    def __init__(self, level, group, index, full_shape, full_placement):
        self.level = level
        self.group = group
        self.n = group.nranks
        self.index = index
        self.full_shape = tuple(full_shape)
        rows = self.full_shape[0] // self.n
        self.lo, self.hi = index * rows, (index + 1) * rows
        self.full_placement = full_placement

    @property
    def stored_sharded(self):
        """True when the stored parameter is its rows (ZeRO-3)."""
        return self.level == "p_g_os"

    @property
    def grad_sharded(self):
        """True when the synced gradient is the rows (ZeRO-2, ZeRO-3)."""
        return self.level in ("os_g", "p_g_os")


def _rows_of(p, mesh, axis="sharding"):
    n = mesh.shape.get(axis, 1)
    if n <= 1 or p.ndim < 1 or p.shape[0] % n:
        return None
    return mesh.coord[axis]


def zero_partition_spec(value, mesh, axis="sharding"):
    """The reference's rule, as a tuple of per-dimension mesh axes: the
    ZeRO axis composed onto dimension 0 of the tensor's own split (a TP
    placement), or None when it cannot or need not be sharded."""
    n = mesh.shape.get(axis, 1)
    if n <= 1 or getattr(value, "ndim", 0) < 1:
        return None
    z = getattr(value, "_zero", None)
    pl = z.full_placement if z is not None else placement_of(value)
    shape = z.full_shape if z is not None else tuple(value.shape)
    if shape[0] % n:
        return None
    names = list(pl.dim_axes) if pl is not None else [()] * len(shape)
    names[0] += (axis,)
    return tuple(None if not a else a[0] if len(a) == 1 else a
                 for a in names)


def _state_placement(p, z):
    base = z.full_placement or Placement.whole(z.full_shape)
    return base.rows(z.lo, z.hi, "sharding")


def state_placement(p, value):
    """The placement of a piece of ``p``'s optimizer state: ``p``'s own for
    state shaped like the stored parameter, its ZeRO rows' for state
    shaped like the rows (a master weight made at the first update)."""
    z = getattr(p, "_zero", None)
    if value.ndim == 0:
        return None
    if tuple(value.shape) == tuple(p.shape):
        return placement_of(p)
    if z is not None and value.shape[0] == z.hi - z.lo:
        return _state_placement(p, z)
    return None


def shard_optimizer_state(optimizer, params, level="os", mesh=None):
    """Partition ``params`` over the sharding group at ``level`` and keep
    only this rank's rows of their optimizer state (existing state is cut;
    missing state is made rows-shaped). Parameters already partitioned keep
    their partition (a higher level wins). Returns the partitioned ones."""
    mesh = mesh or get_default_mesh()
    group = mesh.group("sharding")
    out = []
    for p in params:
        if not p.requires_grad:
            continue
        index = _rows_of(p, mesh)
        old = getattr(p, "_zero", None)
        if old is not None:
            if LEVELS.index(level) > LEVELS.index(old.level):
                old.level = level
            out.append(p)
            continue
        if index is None:
            continue
        z = ZeroShard(level, group, index, p.shape, placement_of(p))
        p._zero = z
        accs = optimizer._accumulators.get(id(p))
        rows = p.detach()[z.lo:z.hi]
        new = optimizer._create_accumulators(rows) if accs is None else {
            k: (v[z.lo:z.hi].clone() if v.ndim >= 1 and
                tuple(v.shape) == z.full_shape else v)
            for k, v in accs.items()}
        for v in new.values():
            if v.ndim >= 1 and v.shape[0] == z.hi - z.lo:
                place(v, _state_placement(p, z))
        optimizer._accumulators[id(p)] = new
        out.append(p)
    return out


# -- ZeRO-3: parameters stored as rows, gathered on use -----------------------
_gathered = {}      # storage address -> (weakref to the whole value, rows, z)


def _forget(addr, ref):
    if _gathered.get(addr, (None,))[0] is ref:
        del _gathered[addr]


def _gather_rows(rows, z):
    """The whole value from every rank's ``rows`` (no autograd)."""
    from ... import comm_plane
    rows = rows.contiguous()
    outs = [torch.empty_like(rows) for _ in range(z.n)]
    comm_plane.async_all_gather(outs, rows, z.group, label="zero3.gather",
                                span="zero3.gather").wait()
    return torch.cat(outs, 0)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, z):
        ctx.z = z
        full = _gather_rows(rows, z)
        addr = full.untyped_storage().data_ptr()
        ref = weakref.ref(full, lambda r, a=addr: _forget(a, r))
        _gathered[addr] = (ref, rows, z)
        return full

    @staticmethod
    def backward(ctx, g):
        from ... import comm_plane
        from ...collective import ReduceOp
        z = ctx.z
        # averaged in fp32 (a bf16 parameter's gradient included), then
        # in the gradient's dtype
        flat = g.reshape(-1).float()
        out = torch.empty((z.hi - z.lo,) + tuple(g.shape[1:]),
                          dtype=torch.float32, device=g.device)
        comm_plane.async_reduce_scatter(
            out, flat, z.group, ReduceOp.AVG,
            label="zero3.grad_rs", span="zero3.reduce_scatter").wait()
        return out.to(g.dtype), None


def _pack(t):
    """Saved for the backward: a gathered parameter is kept as its rows."""
    ent = _gathered.get(t.untyped_storage().data_ptr())
    if ent is not None and ent[0]() is not None:
        return ("zero3", ent[1], ent[2], tuple(t.size()), t.stride(),
                t.storage_offset())
    return t


def _unpack(x):
    if isinstance(x, tuple):
        _, rows, z, size, stride, offset = x
        return _gather_rows(rows.detach(), z).as_strided(size, stride,
                                                         offset)
    return x


_ZERO3_CLASSES = {}


def _zero3_class(cls):
    """``cls`` with an attribute lookup that gathers its sharded
    parameters (a parameter read through its layer is whole)."""
    sub = _ZERO3_CLASSES.get(cls)
    if sub is None:
        def __getattr__(self, name):
            value = cls.__getattr__(self, name)
            z = self.__dict__["_zero3_params"].get(name)
            if z is not None and torch.is_tensor(value) and \
                    value.ndim and value.shape[0] == z.hi - z.lo:
                return _GatherParam.apply(value, z)
            return value

        sub = type(cls.__name__, (cls,), {
            "__getattr__": __getattr__, "__module__": cls.__module__,
            "__qualname__": cls.__qualname__})
        _ZERO3_CLASSES[cls] = sub
    return sub


def _owner_entries(layer):
    seen = set()
    for mod in layer.modules():
        for name, p in mod._parameters.items():
            if p is not None and id(p) not in seen:
                seen.add(id(p))
                yield mod, name, p


class GroupShardedOptimizerStage2:
    """Optimizer-state sharding (ZeRO-1, and ZeRO-2 beside
    ``GroupShardedStage2``): ``step`` averages the gradients over the data
    axes (reduce-scattering the ZeRO-2/3 ones), clips by the global norm
    across the groups, updates this rank's rows and all-gathers them."""

    def __init__(self, params, optim, group=None, offload=False,
                 device="gpu", level="os", **kwargs):
        self._optim = optim
        self._params = [p for p in params if p.requires_grad]
        self._mesh = get_default_mesh()
        shard_optimizer_state(optim, self._params, level, self._mesh)

    def __getattr__(self, item):
        return getattr(self._optim, item)

    @torch.no_grad()
    def step(self):
        from ....optimizer.optimizer import run_pre_step_hooks
        run_pre_step_hooks()
        pairs = [(p, p.grad) for p in self._params if p.grad is not None]
        if not pairs:
            return
        params, grads = [p for p, _ in pairs], [g for _, g in pairs]
        grads = sync_gradients(params, grads, self._mesh)
        grads = hybrid_clip(self._optim._grad_clip, params, grads,
                            self._mesh)
        self._optim._step_count += 1
        sharded_update(self._optim, params, grads, self._optim.get_lr())


class GroupShardedStage2(Layer):
    """Gradient + optimizer-state sharding (ZeRO-2): the layer as it is;
    its parameters' gradients are reduce-scattered by the optimizer's
    step and by ``CompiledTrainStep``."""

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23,
                 auto_refresh_trainable=True, device="gpu", **kwargs):
        super().__init__()
        self._layer = layer
        self._sharding_optimizer = sharding_optimizer

    def forward(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layer.state_dict(*args, **kwargs)

    def set_state_dict(self, state, *args, **kwargs):
        return self._layer.set_state_dict(state, *args, **kwargs)


class GroupShardedStage3(Layer):
    """Parameter sharding with gather-on-use (ZeRO-3)."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 device="gpu", segment_size=2 ** 20, pretrain_sync_once=False,
                 offload=False, **kwargs):
        super().__init__()
        self._layer = layer
        self._optimizer = optimizer
        self._mesh = get_default_mesh()
        self._sharded = self._mesh.shape.get("sharding", 1) > 1
        if self._sharded:
            self._shard_params()

    def _shard_params(self):
        """Store every parameter whose dimension 0 divides as its rows
        (idempotent: a parameter gathered whole is cut again)."""
        group = self._mesh.group("sharding")
        with torch.no_grad():
            for mod, name, p in _owner_entries(self._layer):
                z = getattr(p, "_zero", None)
                if z is None:
                    index = _rows_of(p, self._mesh)
                    if index is None:
                        continue
                    if self._optimizer is not None and p.requires_grad:
                        shard_optimizer_state(self._optimizer, [p],
                                              "p_g_os", self._mesh)
                        z = p._zero
                    else:
                        z = p._zero = ZeroShard("p_g_os", group, index,
                                                p.shape, placement_of(p))
                z.level = "p_g_os"
                if tuple(p.shape) == z.full_shape:
                    p.data = p.data[z.lo:z.hi].clone()
                    place(p, _state_placement(p, z))
                if type(mod) is not _zero3_class(type(mod)):
                    mod.__class__ = _zero3_class(type(mod))
                    mod.__dict__.setdefault("_zero3_params", {})
                mod.__dict__["_zero3_params"][name] = z

    def _whole(self):
        return any(tuple(p.shape) == z.full_shape
                   for p in self._layer.parameters()
                   for z in [getattr(p, "_zero", None)] if z is not None)

    def forward(self, *args, **kwargs):
        if not self._sharded:
            return self._layer(*args, **kwargs)
        if self._whole():
            self._shard_params()
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
            return self._layer(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layer.state_dict(*args, **kwargs)

    def set_state_dict(self, state, *args, **kwargs):
        return self._layer.set_state_dict(state, *args, **kwargs)

    @torch.no_grad()
    def get_all_parameters(self, convert2cpu=False, quant=None, prefetch=1):
        """Gather every sharded parameter back whole; the next forward
        cuts them again. ``quant=None`` takes the active ``comm_quant``
        config (fp32 when none is active), ``quant=False`` forces the
        exact fp32 gather, a config (or True) gathers codes and scales
        (``comm_quant.quantized_replicate``) and round-trips the
        parameters that are not sharded through the codec too, as the
        reference does. ``prefetch`` is accepted for the reference's
        signature: the gathers run one after the other."""
        from ...comm_quant import (get_active_config, quantized_replicate,
                                   resolve_config)
        cfg = get_active_config() if quant is None else resolve_config(quant)
        for p in self._layer.parameters():
            z = getattr(p, "_zero", None)
            rows = z is not None and tuple(p.shape) != z.full_shape
            if cfg is not None:
                p.data = quantized_replicate(p, self._mesh, cfg)
            elif rows:
                p.data = _gather_rows(p.data, z)
            if rows:
                place(p, z.full_placement) if z.full_placement else \
                    p.__dict__.pop("_placement", None)
            if convert2cpu:
                p.data = p.data.cpu()
        return list(self._layer.parameters())


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """upstream ``paddle.distributed.sharding.group_sharded_parallel``:
    (model, optimizer, scaler) with ZeRO at ``level`` over the default
    mesh's sharding group (a degree of 1 changes nothing). A layer that
    places its own parameters (``commit_param_shardings``: a pipelined
    GPT's stage rows and mp pieces) commits them first, as in the
    reference, so ZeRO shards what pp and mp left the rank."""
    if level not in LEVELS:
        raise ValueError(f"bad level {level}")
    for m in model.modules():
        commit = getattr(m, "commit_param_shardings", None)
        if commit is not None:
            commit()
    params = [p for p in model.parameters() if p.requires_grad]
    if level == "p_g_os":
        model = GroupShardedStage3(model, optimizer=optimizer, group=group,
                                   sync_buffers=sync_buffers,
                                   segment_size=segment_size,
                                   offload=offload)
        opt = GroupShardedOptimizerStage2(
            [p for p in model._layer.parameters() if p.requires_grad],
            optimizer, group=group, level=level)
        return model, opt, scaler
    opt = GroupShardedOptimizerStage2(params, optimizer, group=group,
                                      offload=offload, level=level)
    if level == "os_g":
        model = GroupShardedStage2(model, opt, group=group,
                                   sync_buffers=sync_buffers)
    return model, opt, scaler


def _gather_state(optimizer, params):
    """{id(p): accumulators} with every rows-shaped accumulator of a
    partitioned parameter gathered whole (for a whole checkpoint)."""
    out = {}
    for p in params:
        z = getattr(p, "_zero", None)
        accs = optimizer._accumulators.get(id(p), {})
        if z is None:
            continue
        out[id(p)] = {k: (_gather_rows(v, z) if v.ndim >= 1 and
                          v.shape[0] == z.hi - z.lo else v)
                      for k, v in accs.items()}
    return out


def save_group_sharded_model(model, output, optimizer=None):
    """Gather the parameters (and ZeRO's optimizer state) whole, then rank 0
    writes ``model.pdparams`` (and ``model.pdopt``) under ``output``."""
    import os

    from ....framework.io import save
    from ...collective import barrier
    from ...env import get_rank
    inner = getattr(optimizer, "_optim", optimizer)
    if isinstance(model, GroupShardedStage3):
        model.get_all_parameters(quant=False)
    opt_state = None
    if inner is not None:
        params = inner._parameter_list()
        whole = _gather_state(inner, params)
        saved = dict(inner._accumulators)
        inner._accumulators.update(whole)
        opt_state = inner.state_dict()
        inner._accumulators.clear()
        inner._accumulators.update(saved)
    if get_rank() == 0:
        os.makedirs(output, exist_ok=True)
        save(model.state_dict(), os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            save(opt_state, os.path.join(output, "model.pdopt"))
    if dist.is_initialized():
        barrier()


# -- the gradient average, the clip and the update under a mesh ----------------
def _flat_groups(items):
    """Indices grouped by (dtype, device), in order."""
    out = {}
    for i, t in items:
        out.setdefault((t.dtype, t.device), []).append(i)
    return list(out.values())


def _reduce_scatter_rows(params, grads, group):
    """Each ZeRO-2 gradient averaged over ``group`` onto this rank's rows,
    as one flat fp32 reduce-scatter through the comm plane."""
    from ... import comm_plane
    from ...collective import ReduceOp
    n = group.nranks
    flat = torch.cat([g.float().reshape(n, -1) for g in grads], dim=1)
    out = torch.empty(flat.shape[1], dtype=torch.float32, device=flat.device)
    comm_plane.async_reduce_scatter(
        out, flat.reshape(-1), group, ReduceOp.AVG,
        label="zero2.grad_rs", span="zero2.reduce_scatter",
        nelem=flat.numel()).wait()
    res, off = [], 0
    for p, g in zip(params, grads):
        z = p._zero
        rows = (z.hi - z.lo,) + tuple(g.shape[1:])
        k = g.numel() // n
        res.append(out[off:off + k].view(rows).to(g.dtype))
        off += k
    return res


def sync_gradients(params, grads, mesh, sync_plain=True, bucket_mb=25):
    """The gradients averaged over the data axes (``mesh.data_axes``: dcn
    when the mesh has it, dp and sharding), never over mp: a whole
    gradient all-reduced over all of them (``sync_plain``), a ZeRO-2 one
    reduce-scattered onto its rows over sharding, a ZeRO-3 one (already
    averaged over sharding by its gather's backward) and the ZeRO-2 rows
    averaged over the rest (dcn and dp).

    On a mesh with a sep axis, the gradient of a parameter the model
    marks ``_sep_partial`` (``text/gpt.py``'s ``GPTForPretraining`` under
    ``context_parallel``: each sep rank differentiated the global loss
    through its own chunk of the sequence) is first summed over sep,
    whether or not a DataParallel averaged it over the data axes: a whole
    gradient before ZeRO-2's reduce-scatter, a ZeRO-3 one as its rows
    (the sep ranks of a sharding coordinate hold the same rows). Any other
    model's sep ranks hold the whole sequence and the whole gradient, so
    it takes no sum over sep.

    On a mesh with a pp axis, a parameter outside the pipeline
    (``_pp_replicated``: replicated over pp, each rank holding its 1/pp
    share of the gradient, ``text/gpt.py`` ``GPTForPretrainingPipe``) is
    first summed over pp (its ZeRO-3 rows, already reduce-scattered, the
    same way), so every pp rank ends with the whole gradient, then
    averaged or reduce-scattered over sharding like any other; a stage's
    own rows keep their stage's gradient and are averaged or
    reduce-scattered over sharding only. A leaf replicated over mp (a
    norm, a row-parallel bias, the embeddings) takes no sum over mp: every
    mp rank computed its whole gradient."""
    from ...collective import ReduceOp
    from ...parallel import all_reduce_gradients
    grads = list(grads)
    pp = mesh.group("pp")
    if pp.nranks > 1:
        rep = [i for i, p in enumerate(params)
               if getattr(p, "_pp_replicated", False)]
        if rep:
            summed = all_reduce_gradients([grads[i] for i in rep], pp,
                                          bucket_mb, op=ReduceOp.SUM)
            for i, g in zip(rep, summed):
                grads[i] = g
    sep = mesh.group("sep")
    if sep.nranks > 1:
        split = [i for i, p in enumerate(params)
                 if getattr(p, "_sep_partial", False)]
        if split:
            summed = all_reduce_gradients([grads[i] for i in split], sep,
                                          bucket_mb, op=ReduceOp.SUM)
            for i, g in zip(split, summed):
                grads[i] = g
    out = list(grads)
    plain, rs, z3 = [], [], []
    for i, p in enumerate(params):
        z = getattr(p, "_zero", None)
        if z is None or not z.grad_sharded:
            plain.append(i)
        elif z.stored_sharded:
            z3.append(i)
        else:
            rs.append(i)
    if plain and sync_plain:
        synced = all_reduce_gradients([grads[i] for i in plain],
                                      mesh.group(*mesh.data_axes), bucket_mb)
        for i, g in zip(plain, synced):
            out[i] = g
    if rs:
        synced = _reduce_scatter_rows([params[i] for i in rs],
                                      [grads[i] for i in rs],
                                      mesh.group("sharding"))
        for i, g in zip(rs, synced):
            out[i] = g
    rows = rs + z3
    if rows:
        synced = all_reduce_gradients([out[i] for i in rows],
                                      mesh.group(*mesh.data_axes[:-1]),
                                      bucket_mb)
        for i, g in zip(rows, synced):
            out[i] = g
    return out


def is_mp_split(p):
    """True for a parameter split over mp (``is_distributed`` set by a TP
    layer; a torch tensor's own ``is_distributed`` is a method)."""
    return p.__dict__.get("is_distributed", False) is True


def hybrid_clip(clip, params, grads, mesh):
    """The optimizer's clip with a global norm across the groups, each
    element of the global model counted once: the squares of a gradient
    summed over sharding when it is ZeRO rows, over mp when it is split
    over mp (``is_distributed``), over pp when it is a pipeline stage's
    own (``_pp_stage``: an eager stage's layer, a stacked row), and over
    no axis it is replicated on; the same scale as
    ``ClipGradByGlobalNorm`` in one process on the whole model.
    ``ClipGradByNorm`` scales each gradient by the norm of its whole
    logical gradient, its squares summed the same way
    (``_clip_by_norm``).
    Every parameter is replicated over sep, and every sep rank holds its
    whole gradient by the clip (summed over sep by ``sync_gradients``
    where the model split the sequence), so no sum runs over sep: each
    counts once."""
    from ....nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, \
        ClipGradByValue
    if clip is None:
        return grads
    if isinstance(clip, ClipGradByValue):
        return [torch.clamp(g, clip.min, clip.max) for g in grads]
    if isinstance(clip, ClipGradByNorm):
        return _clip_by_norm(clip, params, grads, mesh)
    if not isinstance(clip, ClipGradByGlobalNorm):
        raise TypeError(f"unsupported grad clip in the train step: {clip!r}")
    from ...collective import all_reduce
    dev = grads[0].device
    # the squares by the axes they are summed over: bit 0 sharding, bit 1
    # mp, bit 2 pp
    parts = torch.zeros(8, dtype=torch.float32, device=dev)
    staged = mesh.group("pp").nranks > 1
    for p, g in zip(params, grads):
        z = getattr(p, "_zero", None)
        k = (z is not None and z.grad_sharded) + 2 * is_mp_split(p) + \
            4 * (staged and getattr(p, "_pp_stage", None) is not None)
        parts[k] += torch.sum(torch.square(g.float()))
    bits = torch.arange(8, device=dev)
    for axis, bit in (("sharding", 1), ("mp", 2), ("pp", 4)):
        group = mesh.group(axis)
        if group.nranks > 1:
            mask = (bits & bit) > 0
            summed = torch.where(mask, parts, torch.zeros_like(parts))
            all_reduce(summed, group=group)
            parts = torch.where(mask, summed, parts)
    total = parts.sum()
    scale = torch.clamp(clip.clip_norm / torch.clamp(torch.sqrt(total),
                                                     min=1e-12), max=1.0)
    return [g * scale.to(g.dtype) for g in grads]


def _split_over(p):
    """(split over mp, ZeRO rows over sharding, rows of a tensor split
    over pp) of ``p``'s gradient."""
    z = getattr(p, "_zero", None)
    pl = z.full_placement if z is not None else placement_of(p)
    return (is_mp_split(p), z is not None and z.grad_sharded,
            pl is not None and "pp" in pl.axes)


def _clip_by_norm(clip, params, grads, mesh):
    """``ClipGradByNorm`` over split parameters: each gradient scaled by
    the L2 norm of its whole logical gradient (the reference clips the
    whole gradient of each parameter). A whole gradient takes the plain
    clip; a split one sums its fp32 squares over mp, over sharding and,
    for a stacked leaf's stage rows, over pp (one all-reduce of every
    split parameter's squares per group)."""
    from ...collective import all_reduce
    split = [_split_over(p) for p in params]
    if not any(any(s) for s in split):
        return [clip([(None, g)])[0][1] for g in grads]
    dev = grads[0].device
    sq = torch.stack([torch.sum(torch.square(g.float())) for g in grads])
    for axis, k in (("mp", 0), ("sharding", 1), ("pp", 2)):
        group = mesh.group(axis)
        mask = torch.tensor([s[k] for s in split], device=dev)
        if group.nranks > 1 and bool(mask.any()):
            part = torch.where(mask, sq, torch.zeros_like(sq))
            all_reduce(part, group=group)
            sq = torch.where(mask, part, sq)
    out = []
    for s_over, g, s in zip(split, grads, sq):
        if not any(s_over):
            out.append(clip([(None, g)])[0][1])
            continue
        scale = torch.clamp(clip.clip_norm / torch.clamp(torch.sqrt(s),
                                                         min=1e-12), max=1.0)
        out.append(g * scale.to(g.dtype))
    return out


def _all_gather_rows(params):
    """After a ZeRO-1/2 update: every rank's updated rows into every
    rank's parameter, one flat all-gather per (dtype, device) through the
    comm plane."""
    from ... import comm_plane
    if not params:
        return
    works = []
    for idx in _flat_groups([(i, p) for i, p in enumerate(params)]):
        ps = [params[i] for i in idx]
        z0 = ps[0]._zero
        flat = torch.cat([p.data[p._zero.lo:p._zero.hi].reshape(-1)
                          for p in ps])
        outs = [torch.empty_like(flat) for _ in range(z0.n)]
        works.append((ps, outs, comm_plane.async_all_gather(
            outs, flat, z0.group, label="zero.param_gather",
            span="zero.all_gather", nelem=flat.numel())))
    for ps, outs, work in works:
        work.wait()
        for r, buf in enumerate(outs):
            off = 0
            for p in ps:
                z = p._zero
                k = (z.hi - z.lo) * (p.numel() // p.shape[0])
                rows = p.data[r * (z.hi - z.lo):(r + 1) * (z.hi - z.lo)]
                rows.copy_(buf[off:off + k].view(rows.shape))
                off += k


@torch.no_grad()
def sharded_update(optimizer, params, grads, lr):
    """The optimizer's update in place: a whole or ZeRO-3 parameter as
    it is stored, a ZeRO-1/2 parameter on its rows (then gathered)."""
    gather = []
    for p, g in zip(params, grads):
        z = getattr(p, "_zero", None)
        if z is None or z.stored_sharded or tuple(p.shape) != z.full_shape:
            optimizer._apply(p, g, lr)
            continue
        if tuple(g.shape) == z.full_shape:
            g = g[z.lo:z.hi]
        optimizer._apply(p, g, lr, target=p.data[z.lo:z.hi])
        gather.append(p)
    _all_gather_rows(gather)


def state_bytes(optimizer, params):
    """(parameter bytes, optimizer-state bytes) this rank holds."""
    pb = sum(p.numel() * p.element_size() for p in params)
    ob = sum(v.numel() * v.element_size()
             for p in params
             for v in optimizer._accumulators.get(id(p), {}).values()
             if torch.is_tensor(v))
    return pb, ob
