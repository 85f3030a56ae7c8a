"""``paddle.DataParallel`` with bucketed gradient sync (counterpart:
``paddle_tpu/distributed/parallel.py``; upstream's C++ Reducer).

- **Buckets.** The trainable parameters are packed in reverse order
  (parameters used last in the forward get their gradients first) into
  buckets of at most ``comm_buffer_size`` MB of fp32; the first bucket
  and the tail bucket (the first layers, whose gradients come last) are
  capped at ``last_comm_buffer_size`` MB, so the first all-reduce starts
  early and the exposed tail is short. With ``comm_quant`` every
  parameter's slab starts on a codec block, so no scale block spans two
  parameters.
- **Launch.** A per-parameter grad-ready hook (``autograd.tape.
  register_grad_ready_hook``, PyTorch's post-accumulate-grad hook) marks
  the parameter; once every parameter of a bucket is ready the bucket's
  gradients are flattened into one fp32 slab and its AVG all-reduce is
  launched on the backend (``async_op=True``, through the comm plane), in
  bucket order on every rank, while the backward walk goes on. Once it
  landed, the waiter copies the synced slab back into ``.grad`` (a
  parameter that got no gradient contributes zeros and gets the synced
  value). A quantized bucket's schedule runs at its launch.
- **The end of a backward.** The first hook of a backward queues a
  callback at the end of that backward (``queue_callback`` of PyTorch's
  engine, as DDP does); it launches the buckets still waiting (unused
  parameters) and drains the plane, so the gradients are synced when
  ``backward()`` returns, whether the loss is a torch tensor or a paddle
  ``Tensor``. ``Optimizer.step``, ``clear_grad`` and
  ``GradScaler.unscale_`` drain again through the pre-step hook.
- **The rest of the contract.** ``no_sync()`` accumulates locally and
  the first backward outside it syncs the sum; wrapping broadcasts the
  parameters and buffers from the group's first rank; buckets are
  rebuilt when the model's trainable parameters change (checked at each
  forward); ``ErrorFeedback`` residuals are keyed by the parameter's
  name; ``_sync_count`` and ``_bucket_launch_count`` count syncs and
  bucket launches. In a world of one process a bucket launch is counted
  and moves nothing.

``all_reduce_gradients`` is the same average for a list of gradients the
caller holds (``CompiledTrainStep``, which takes its gradients with
``torch.autograd.grad`` and so never fires the hooks).
"""
from __future__ import annotations

import contextlib
import weakref

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..nn.layer.layers import Layer


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


class _GradBucket:
    """One reverse-ordered slab of trainable parameters synced as a single
    flat fp32 all-reduce."""

    __slots__ = ("index", "params", "names", "shapes", "nelem", "ready",
                 "_layouts")

    def __init__(self, index, params, names):
        self.index = index
        self.params = list(params)
        self.names = list(names)
        self.shapes = [tuple(p.shape) for p in self.params]
        self.nelem = sum(_numel(s) for s in self.shapes)
        self.ready = set()
        self._layouts = {}

    def layout(self, align=1):
        """(offsets, padded length) of the parameters in the flat slab,
        each slab padded to a multiple of ``align``."""
        align = max(int(align), 1)
        cached = self._layouts.get(align)
        if cached is None:
            offsets, off = [], 0
            for shape in self.shapes:
                offsets.append(off)
                off += -(-_numel(shape) // align) * align
            cached = self._layouts[align] = (offsets, off)
        return cached


def _sync_group(group):
    """The group a sync runs over, or None when there is nothing to
    reduce (a world of one process, or a group of one)."""
    from .collective import _get_group
    if not dist.is_initialized():
        return None
    g = _get_group(group)
    return g if g.nranks > 1 else None


def _plan_buckets(sizes, cap_mb, small_mb):
    """Index lists of the buckets over tensors of ``sizes`` elements,
    taken in the order given: the first bucket and a tail split off the
    last are capped at ``small_mb``, the rest at ``cap_mb`` (fp32 MB)."""
    cap = max(float(cap_mb), 1e-6) * (1 << 20)
    small = min(max(float(small_mb), 1e-6) * (1 << 20), cap)
    nbytes = [4 * n for n in sizes]
    groups, cur, cur_bytes = [], [], 0.0
    for i, nb in enumerate(nbytes):
        limit = small if not groups else cap
        if cur and cur_bytes + nb > limit:
            groups.append(cur)
            cur, cur_bytes = [], 0.0
        cur.append(i)
        cur_bytes += nb
    if cur:
        groups.append(cur)
    if groups and len(groups[-1]) > 1 and \
            sum(nbytes[i] for i in groups[-1]) > small:
        tail, tail_bytes = [], 0.0
        while len(groups[-1]) > 1 and \
                tail_bytes + nbytes[groups[-1][-1]] <= small:
            i = groups[-1].pop()
            tail.insert(0, i)
            tail_bytes += nbytes[i]
        if tail:
            groups.append(tail)
    return groups


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, comm_quant=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._grad_sync_enabled = True
        self._group = group
        self._comm_quant = comm_quant
        self._error_feedback = None
        self._sync_count = 0
        self._quant_sync_count = 0
        self._bucket_launch_count = 0
        self._comm_buffer_size = comm_buffer_size
        self._last_comm_buffer_size = last_comm_buffer_size
        self._buckets = []
        self._bucket_of = {}
        self._bucket_param_ids = ()
        self._ready_handles = []
        self._round_launched = set()
        self._round_seq = None
        self._round_quant = None
        self._build_buckets()
        if _sync_group(group) is not None:
            src = min(group.ranks) if group is not None else 0
            sync_params_buffers(layers, comm_group=group, src_rank=src)

    def __del__(self):
        for h in getattr(self, "_ready_handles", ()):
            h.remove()

    def forward(self, *inputs, **kwargs):
        if not self._buckets_current():
            self._build_buckets()
        return self._layers(*inputs, **kwargs)

    # -- bucketing -----------------------------------------------------------
    def _trainable(self):
        return [(n, p) for n, p in self._layers.named_parameters()
                if p.requires_grad]

    def _build_buckets(self):
        for h in self._ready_handles:
            h.remove()
        self._ready_handles = []
        named = list(reversed(self._trainable()))
        plan = _plan_buckets([p.numel() for _, p in named],
                             self._comm_buffer_size,
                             self._last_comm_buffer_size)
        self._buckets = [
            _GradBucket(i, [named[j][1] for j in idx],
                        [named[j][0] for j in idx])
            for i, idx in enumerate(plan)]
        self._bucket_of = {id(p): b for b in self._buckets
                           for p in b.params}
        self._bucket_param_ids = tuple(sorted(id(p) for _, p in named))
        from ..autograd.tape import register_grad_ready_hook
        ref = weakref.ref(self)

        def ready(t):
            m = ref()
            if m is not None:
                m._on_grad_ready(t)

        for _, p in named:
            self._ready_handles.append(register_grad_ready_hook(p, ready))

    def _buckets_current(self):
        return self._bucket_param_ids == tuple(
            sorted(id(p) for _, p in self._trainable()))

    # -- the overlapped reducer ----------------------------------------------
    def _begin_round_if_needed(self):
        """A round belongs to one backward (PyTorch's graph task): the
        first hook of a new backward clears what an earlier, aborted one
        left and queues the end-of-backward callback."""
        seq = torch._C._current_graph_task_id()
        if self._round_seq == seq and seq != -1:
            return
        self._reset_round()
        self._round_seq = seq
        if seq != -1:
            ref = weakref.ref(self)

            def finish():
                m = ref()
                if m is not None and m._round_seq == seq:
                    m._end_of_backward()

            torch.autograd.Variable._execution_engine.queue_callback(finish)

    def _on_grad_ready(self, p):
        if not self._grad_sync_enabled:
            return
        self._begin_round_if_needed()
        b = self._bucket_of.get(id(p))
        if b is None or b.index in self._round_launched:
            return
        b.ready.add(id(p))
        for bucket in self._buckets:
            if bucket.index in self._round_launched:
                continue
            if len(bucket.ready) < len(bucket.params):
                break   # bucket order on every rank: predecessors first
            self._launch_bucket(bucket)

    def _quant(self):
        if self._round_quant is None:
            from . import comm_quant as cq
            if self._comm_quant is False:
                cfg = None
            elif self._comm_quant is None:
                cfg = cq.get_active_config()
            else:
                cfg = cq.resolve_config(self._comm_quant)
            self._round_quant = (cfg,)
        return self._round_quant[0]

    def _ef(self, cfg):
        from . import comm_quant as cq
        if cfg is None or not cfg.error_feedback:
            return None
        if self._error_feedback is None or self._error_feedback._cfg != cfg:
            self._error_feedback = cq.ErrorFeedback(cfg)
        live = {n for b in self._buckets for n in b.names}
        for key in [k for k in self._error_feedback._resid
                    if k not in live]:
            del self._error_feedback._resid[key]
        return self._error_feedback

    def _launch_bucket(self, bucket):
        """Flatten the bucket's gradients into one fp32 slab on this thread
        and launch its AVG all-reduce through the comm plane."""
        from . import comm_plane
        from .collective import ReduceOp
        self._round_launched.add(bucket.index)
        self._bucket_launch_count += 1
        group = _sync_group(self._group)
        if group is None or group.rank < 0:
            return
        cfg = self._quant()
        ef = self._ef(cfg)
        offsets, nelem = bucket.layout(cfg.block_size if cfg else 1)
        grads = [p.grad for p in bucket.params]
        if cfg is None and all(g is not None for g in grads):
            flat = torch.cat([g.reshape(-1).to(torch.float32)
                              for g in grads])
        else:
            flat = torch.zeros(nelem, dtype=torch.float32,
                               device=bucket.params[0].device)
            for g, name, off in zip(grads, bucket.names, offsets):
                if g is None:
                    continue
                if ef is not None:
                    g = ef.compensate(name, g)
                flat[off:off + g.numel()].copy_(g.reshape(-1))

        def copy_back(out):
            with torch.no_grad():
                for p, off, shape in zip(bucket.params, offsets,
                                         bucket.shapes):
                    synced = out[off:off + _numel(shape)].view(shape)
                    if p.grad is None:
                        p.grad = synced.to(p.dtype)
                    else:
                        p.grad.copy_(synced)

        comm_plane.async_all_reduce(
            flat, group, ReduceOp.AVG, cfg, then=copy_back,
            label=f"dp.bucket{bucket.index}", span="dp.bucket_launch",
            bucket=bucket.index, params=len(bucket.params), nelem=nelem,
            quant=cfg.dtype if cfg else "fp32")

    def _end_of_backward(self):
        from . import comm_plane
        self._finish_grad_sync()
        comm_plane.drain()

    def _finish_grad_sync(self):
        """Launch every bucket not launched yet, in order, and count the
        sync."""
        from ..observability import trace as _obs_trace
        with _obs_trace.span("dp.grad_sync", sync=self._sync_count,
                             buckets=len(self._buckets),
                             launched_eager=len(self._round_launched)):
            for bucket in self._buckets:
                if bucket.index not in self._round_launched:
                    self._launch_bucket(bucket)
        if self._quant() is not None:
            self._quant_sync_count += 1
        self._sync_count += 1
        self._reset_round()

    def _reset_round(self):
        self._round_launched = set()
        self._round_quant = None
        self._round_seq = None
        for b in self._buckets:
            b.ready = set()

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside accumulate their gradients locally; the first
        backward after it syncs the sum."""
        prev = self._grad_sync_enabled
        self._grad_sync_enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = prev

    def apply_collective_grads(self):
        """Average every trainable gradient now, as the gradients stand,
        and wait for it."""
        from . import comm_plane
        self._reset_round()
        self._finish_grad_sync()
        comm_plane.drain()

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)


def all_reduce_gradients(grads, group=None, bucket_mb=25, op=None):
    """Average ``grads`` over ``group`` (the world by default; ``op``
    ``ReduceOp.SUM`` sums them) as flat fp32 buckets of at most
    ``bucket_mb`` MB through the comm plane; returns the reduced tensors,
    each in its own dtype. In a world of one process it returns
    ``grads``."""
    from . import comm_plane
    from .collective import ReduceOp
    op = ReduceOp.AVG if op is None else op
    g = _sync_group(group)
    if g is None:
        return grads
    plan = _plan_buckets([x.numel() for x in grads], bucket_mb, bucket_mb)
    slabs = []
    for idx in plan:
        flat = torch.cat([grads[i].reshape(-1).to(torch.float32)
                          for i in idx])
        comm_plane.async_all_reduce(
            flat, g, op, label="train_step.grad_sync",
            span="dp.bucket_launch", nelem=flat.numel(), quant="fp32")
        slabs.append(flat)
    comm_plane.drain()
    out = list(grads)
    for idx, flat in zip(plan, slabs):
        off = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[off:off + n].view(grads[i].shape).to(
                grads[i].dtype)
            off += n
    return out


def sync_params_buffers(model, comm_group=None, src_rank=0,
                        is_model_parallel=False):
    """Broadcast ``model``'s parameters and buffers from ``src_rank`` so
    every replica starts bit-identical (one broadcast per dtype and
    device). A world of one process, or a group of one, is a no-op.
    Replicas whose shapes differ raise ValueError."""
    from . import collective
    from ..observability import trace as _obs_trace
    g = _sync_group(comm_group)
    if g is None or g.rank < 0:
        return
    if src_rank not in g.ranks:
        raise ValueError(f"sync_params_buffers: src_rank {src_rank} is not "
                         f"in group {g.ranks}")
    tensors = [t.data for t in model.parameters()] + \
        [b for b in model.buffers()]
    shapes = [tuple(t.shape) for t in tensors]
    seen = []
    collective.all_gather_object(seen, shapes, group=comm_group)
    if any(s != seen[0] for s in seen):
        raise ValueError(
            f"sync_params_buffers: rank {collective.get_rank()} holds shapes "
            "that differ from another rank's: replicas must construct "
            "identical models")
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    with _obs_trace.span("dp.sync_params", tensors=len(tensors),
                         src=src_rank), torch.no_grad():
        for group_tensors in by_kind.values():
            flat = _flatten_dense_tensors(group_tensors)
            collective.broadcast(flat, src_rank, group=comm_group)
            for t, v in zip(group_tensors,
                            _unflatten_dense_tensors(flat, group_tensors)):
                t.copy_(v)
