"""The eager collective API (counterpart: ``paddle_tpu/distributed/
collective.py``) over ``torch.distributed``.

A ``Group`` is an ordered list of global ranks with its process group;
the default group is the world ``init_parallel_env`` joined. Every call
takes paddle ``Tensor``s or torch tensors and works in place, as upstream
Paddle's does; ``all_gather`` and ``alltoall`` fill the list they are
given with tensors of the input's kind.

Meanings kept from the reference:

- ``ReduceOp.AVG`` is a SUM and then a division by the group's size in
  the tensor's dtype, ``(a + b) / n`` as the reference computes it; gloo
  and NCCL have no average that matches it. Integer tensors divide with
  floor.
- ``all_reduce(quant=...)`` runs the two-phase quantized schedule of
  ``comm_quant``: int8 codes and fp32 block scales cross the wire, the
  sums are fp32. ``sync_op=False`` returns a pending ``CollectiveWork``
  of the comm plane.
- A receive past its deadline (``PADDLE_P2P_TIMEOUT`` seconds, 300 by
  default, 0 for none) raises ``P2PTimeout``.
- In a world of one process (no ``init_parallel_env``) every collective
  is an identity.

Where upstream and the reference part ways, the port takes upstream's
meaning: ``reduce`` leaves its result on ``dst`` only, and
``reduce_scatter`` and ``alltoall`` take one contribution per peer from
each rank. The reference's single-controller replica math (a SUM of a
replicated value is ``value * n``) and its stacked ``[world, ...]``
inputs are TPU devices, not ported (ROADMAP C).

A call reaches the backend when it is made, after any collective the
comm plane launched before it, so a bucket's all-reduce and a user's
collective reach every rank in one order. Gloo takes CUDA tensors for
some collectives and not for others: one it refuses raises, naming the
op and the backend.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .env import get_rank, get_world_size

P2P_TIMEOUT_ENV = "PADDLE_P2P_TIMEOUT"
_DEFAULT_P2P_TIMEOUT = 300.0


class P2PTimeout(TimeoutError):
    """A receive's deadline passed: the peer is dead, wedged or never
    sent."""


def default_p2p_timeout():
    """The receive deadline in seconds (``PADDLE_P2P_TIMEOUT``; 0 or less
    means none, returned as None)."""
    try:
        t = float(os.environ.get(P2P_TIMEOUT_ENV, _DEFAULT_P2P_TIMEOUT))
    except ValueError:
        t = _DEFAULT_P2P_TIMEOUT
    return t if t > 0 else None


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """A communicator: an ordered list of global ranks and the
    ``torch.distributed`` process group over them (None for the world
    group, and in a world of one process)."""

    def __init__(self, ranks=None, pg=None, name=None):
        world = get_world_size()
        self.ranks = list(ranks) if ranks is not None else list(range(world))
        self.nranks = len(self.ranks)
        self.pg = pg
        self.name = name or "default"

    @property
    def rank(self):
        r = get_rank()
        return self.ranks.index(r) if r in self.ranks else -1

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(ranks={self.ranks})"


_default_group = None


def _get_group(group=None):
    global _default_group
    if group is not None:
        return group
    if _default_group is None or \
            _default_group.nranks != get_world_size():
        _default_group = Group()
    return _default_group


def new_group(ranks=None, backend=None, timeout=None):
    """A group over ``ranks`` (every rank of the world must call it, as
    ``torch.distributed.new_group`` requires)."""
    ranks = sorted(ranks) if ranks is not None else \
        list(range(get_world_size()))
    pg = None
    if dist.is_initialized():
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=float(timeout))
        pg = dist.new_group(ranks, backend=backend, **kw)
    return Group(ranks, pg)


def get_group(gid=0):
    return _get_group()


def _raw(t):
    """The torch tensor behind a paddle ``Tensor`` (or the tensor itself)."""
    return getattr(t, "_value", t)


def _like(template, value):
    """``value`` as the kind of tensor ``template`` is."""
    if isinstance(template, torch.Tensor):
        return value
    from ..tensor import Tensor
    return Tensor._wrap(value)


def _live():
    """True when the collective must run (``torch.distributed`` is up);
    False in a world of one process, where it is an identity."""
    return dist.is_initialized()


def _solo(g):
    """True when a collective over ``g`` involves this rank alone and is an
    identity: no world, or a group of one rank in a larger world (a mesh
    axis of degree 1), whose process group is None, which
    ``torch.distributed`` would take for the world. A live world of one
    process still runs its collectives through the backend."""
    return not _live() or (g.nranks == 1 and get_world_size() > 1)


def get_backend(group=None):
    if not dist.is_initialized():
        return "gloo"
    return dist.get_backend(_get_group(group).pg)


def _run(name, group, tensors, fn):
    """Run ``fn`` (one ``torch.distributed`` call). On gloo a refusal of
    CUDA tensors raises, naming ``name``."""
    try:
        return fn()
    except RuntimeError as e:
        cuda = any(t.is_cuda for t in tensors)
        if cuda and get_backend(group) == "gloo":
            raise RuntimeError(
                f"{name} on CUDA tensors is refused by the gloo "
                f"backend: {e}") from e
        raise


def _divide(t, n):
    if t.is_floating_point() or t.is_complex():
        t.div_(n)
    else:
        t.floor_divide_(n)


def _reduce_scatter_single(*args, **kwargs):
    # torch renamed reduce_scatter_tensor to reduce_scatter_single; the
    # card's torch has only the old name (looked up at each call, as every
    # other collective is)
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    return fn(*args, **kwargs)


class _Done:
    """The handle of a collective that already landed."""

    def is_completed(self):
        return True

    def wait(self, timeout=None):
        return True


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               quant=None):
    """Reduce ``tensor`` over ``group`` in place. ``quant``: the
    quantized wire (a ``comm_quant.QuantConfig``, True for the active
    one), SUM and AVG only. ``sync_op=False``: a pending
    ``CollectiveWork``."""
    from . import comm_plane
    from . import comm_quant as cq
    g = _get_group(group)
    quant_cfg = cq.resolve_config(quant)
    if quant_cfg is not None and op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError(
            "quantized all_reduce supports SUM/AVG only (max/min/prod do "
            "not commute with block-scaled integer accumulation)")
    t = _raw(tensor)
    if not sync_op:
        return comm_plane.async_all_reduce(t, g, op, quant_cfg)
    if _live() and g.rank < 0:
        return _Done()
    out = _run("all_reduce", g, [t],
               lambda: comm_plane.reduce_array(t, g, op, quant_cfg))
    if out is not t:
        t.copy_(out)
    return _Done()


def all_gather(tensor_list, tensor, group=None, sync_op=True, quant=None):
    """Every rank's ``tensor``, in rank order, into ``tensor_list``.
    ``quant``: each rank's tensor crosses as int8 codes and scales and
    every rank decodes the same rows."""
    from . import comm_quant as cq
    g = _get_group(group)
    t = _raw(tensor)
    quant_cfg = cq.resolve_config(quant)
    tensor_list.clear()
    if _solo(g):
        v = t if quant_cfg is None else cq.quantization_roundtrip(
            t, quant_cfg)
        tensor_list.extend(_like(tensor, v.clone()) for _ in range(g.nranks))
        return _Done()
    if quant_cfg is not None:
        q, s = cq.quantize_blockwise(t, quant_cfg)
        qs = [torch.empty_like(q) for _ in range(g.nranks)]
        ss = [torch.empty_like(s) for _ in range(g.nranks)]
        _run("all_gather", g, [q], lambda: _gather_codes(qs, ss, q, s, g))
        tensor_list.extend(
            _like(tensor, cq.dequantize_blockwise(
                qs[i], ss[i], t.shape, t.dtype, quant_cfg))
            for i in range(g.nranks))
        return _Done()
    rows = [torch.empty_like(t) for _ in range(g.nranks)]
    _run("all_gather", g, [t],
         lambda: dist.all_gather(rows, t.contiguous(), group=g.pg))
    tensor_list.extend(_like(tensor, r) for r in rows)
    return _Done()


def _gather_codes(qs, ss, q, s, g):
    from . import comm_quant as cq
    wires = [cq.wire_view(x) for x in qs]
    dist.all_gather(wires, cq.wire_view(q), group=g.pg)
    dist.all_gather(ss, s, group=g.pg)


def all_gather_object(object_list, obj, group=None):
    g = _get_group(group)
    object_list.clear()
    if _solo(g):
        object_list.extend([obj] * g.nranks)
        return
    out = [None] * g.nranks
    _run("all_gather_object", g, [],
         lambda: dist.all_gather_object(out, obj, group=g.pg))
    object_list.extend(out)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``src``'s tensor (``src`` a global rank) into every rank's."""
    g = _get_group(group)
    if not _solo(g):
        t = _raw(tensor)
        _run("broadcast", g, [t],
             lambda: dist.broadcast(t, src, group=g.pg))
    return _Done()


def broadcast_object_list(object_list, src=0, group=None):
    g = _get_group(group)
    if not _solo(g):
        _run("broadcast_object_list", g, [],
             lambda: dist.broadcast_object_list(object_list, src,
                                                group=g.pg))
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """``src``'s k-th object lands on group rank k."""
    g = _get_group(group)
    objs = list(in_object_list or [])
    if _solo(g):
        if len(objs) != g.nranks:
            raise ValueError(
                f"scatter_object_list: got {len(objs)} objects for a "
                f"{g.nranks}-rank group")
        out_object_list[:] = [objs[max(g.rank, 0)]]
        return out_object_list
    if get_rank() == src and len(objs) != g.nranks:
        raise ValueError(
            f"scatter_object_list: src rank {src} supplied {len(objs)} "
            f"objects for a {g.nranks}-rank group")
    out = [None]
    _run("scatter_object_list", g, [],
         lambda: dist.scatter_object_list(
             out, objs if get_rank() == src else None, src, group=g.pg))
    out_object_list[:] = out
    return out_object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction over ``group`` lands on ``dst`` (a global rank); the
    other ranks keep their tensors."""
    g = _get_group(group)
    if _solo(g):
        return _Done()
    t = _raw(tensor)
    keep = None if get_rank() == dst else t.clone()

    def run():
        dist.reduce(t, dst, op=_TORCH_OPS[op], group=g.pg)
        if keep is not None:
            t.copy_(keep)
        elif op == ReduceOp.AVG:
            _divide(t, g.nranks)

    _run("reduce", g, [t], run)
    return _Done()


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Group rank k receives ``src``'s ``tensor_list[k]``."""
    g = _get_group(group)
    t = _raw(tensor)
    if _solo(g):
        if tensor_list:
            t.copy_(_raw(tensor_list[max(g.rank, 0)]))
        return _Done()
    parts = [_raw(x).contiguous() for x in tensor_list] \
        if get_rank() == src else None
    _run("scatter", g, [t],
         lambda: dist.scatter(t, parts, src, group=g.pg))
    return _Done()


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True, quant=None):
    """Group rank k receives the reduction over ranks of their
    ``tensor_list[k]``. ``quant``: each contribution crosses the wire as
    int8 codes and scales once; the sums stay fp32."""
    from . import comm_quant as cq
    g = _get_group(group)
    t = _raw(tensor)
    quant_cfg = cq.resolve_config(quant)
    parts = [_raw(x) for x in tensor_list]
    if len(parts) != g.nranks:
        raise ValueError(f"reduce_scatter: {len(parts)} tensors for a "
                         f"{g.nranks}-rank group")
    if quant_cfg is not None:
        if op not in (ReduceOp.SUM, ReduceOp.AVG):
            raise NotImplementedError(
                "quantized reduce_scatter supports SUM/AVG only")
        if _solo(g):
            out = cq.quantization_roundtrip(parts[max(g.rank, 0)].float(),
                                            quant_cfg)
        else:
            out = _run("reduce_scatter", g, parts,
                       lambda: cq.reduce_scatter_quantized(
                           [p.float() for p in parts], g, quant_cfg))
        if op == ReduceOp.AVG and _live():
            out = out / g.nranks
        t.copy_(out.reshape(t.shape))
        return _Done()
    if _solo(g):
        t.copy_(parts[max(g.rank, 0)])
        return _Done()
    flat = torch.cat([p.reshape(-1) for p in parts])
    # one flat chunk per rank: the backend checks dim 0, not the count
    out = t.view(-1) if t.is_contiguous() else torch.empty(
        t.numel(), dtype=t.dtype, device=t.device)

    def run():
        _reduce_scatter_single(out, flat, op=_TORCH_OPS[op], group=g.pg)
        if out.data_ptr() != t.data_ptr():
            t.copy_(out.view(t.shape))
        if op == ReduceOp.AVG:
            _divide(t, g.nranks)

    _run("reduce_scatter", g, [t], run)
    return _Done()


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Group rank k receives every rank's ``in_tensor_list[k]``, in rank
    order, into ``out_tensor_list`` (equal shapes, one
    ``all_to_all_single`` underneath)."""
    g = _get_group(group)
    ins = [_raw(x) for x in in_tensor_list]
    out_tensor_list.clear()
    if _solo(g):
        out_tensor_list.extend(_like(in_tensor_list[0], x.clone())
                               for x in ins)
        return _Done()
    shape = ins[0].shape
    if any(x.shape != shape for x in ins):
        raise ValueError("alltoall takes tensors of one shape")
    flat_in = torch.cat([x.reshape(-1) for x in ins])
    flat_out = torch.empty_like(flat_in)
    _run("alltoall", g, [flat_in],
         lambda: dist.all_to_all_single(flat_out, flat_in, group=g.pg))
    out_tensor_list.extend(_like(in_tensor_list[0], x.reshape(shape))
                           for x in flat_out.chunk(g.nranks))
    return _Done()


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """``in_tensor``'s leading-dim chunks (``in_split_sizes``, else equal)
    go one to each rank; ``out_tensor`` receives theirs in rank order."""
    g = _get_group(group)
    out, x = _raw(out_tensor), _raw(in_tensor)
    if _solo(g):
        out.copy_(x)
        return _Done()
    if in_split_sizes is None and x.shape[0] % g.nranks:
        raise ValueError(
            f"alltoall_single: leading dim {x.shape[0]} must divide "
            f"evenly by nranks {g.nranks}")
    _run("alltoall_single", g, [x],
         lambda: dist.all_to_all_single(
             out, x.contiguous(), output_split_sizes=out_split_sizes,
             input_split_sizes=in_split_sizes, group=g.pg))
    return _Done()


def _check_peer(peer, group):
    g = _get_group(group)
    if peer not in g.ranks:
        raise ValueError(f"peer rank {peer} is not in group {g.ranks}")
    return g


def _need_world(what):
    if not dist.is_initialized():
        raise RuntimeError(f"{what} to another rank needs "
                           "init_parallel_env under the launcher or spawn "
                           "(this process is the whole world)")


def send(tensor, dst=0, group=None, sync_op=True):
    g = _check_peer(dst, group)
    _need_world("send")
    t = _raw(tensor).contiguous()
    _run("send", g, [t], lambda: dist.send(t, dst, group=g.pg))
    return _Done()


def _wait_recv(work, src, timeout):
    try:
        if timeout is None:
            work.wait()
        else:
            work.wait(datetime.timedelta(seconds=timeout))
    except RuntimeError as e:
        if "timeout" in str(e).lower() or "timed out" in str(e).lower():
            raise P2PTimeout(
                f"recv from rank {src} exceeded the {timeout}s deadline "
                f"({P2P_TIMEOUT_ENV}; 0 disables): peer dead, wedged, or "
                "never sent") from e
        raise


def recv(tensor, src=0, group=None, sync_op=True, timeout=None):
    """Receive into ``tensor`` from ``src``; past ``timeout`` seconds
    (default ``PADDLE_P2P_TIMEOUT``) it raises ``P2PTimeout``."""
    g = _check_peer(src, group)
    _need_world("recv")
    t = _raw(tensor)
    if timeout is None:
        timeout = default_p2p_timeout()
    _run("recv", g, [t],
         lambda: _wait_recv(dist.irecv(t, src, group=g.pg), src, timeout))
    return _Done()


class _P2PRequest:
    """An in-flight ``isend``/``irecv``: ``wait`` honours its deadline."""

    def __init__(self, work, peer, recv):
        self._work = work
        self._peer = peer
        self._recv = recv

    def is_completed(self):
        return self._work.is_completed()

    def wait(self, timeout=None):
        if timeout is None:
            timeout = default_p2p_timeout()
        if self._recv:
            _wait_recv(self._work, self._peer, timeout)
        else:
            self._work.wait()
        return True


def isend(tensor, dst=0, group=None, sync_op=True):
    g = _check_peer(dst, group)
    _need_world("isend")
    return _P2PRequest(dist.isend(_raw(tensor).contiguous(), dst,
                                  group=g.pg), dst, False)


def irecv(tensor, src=0, group=None, sync_op=True):
    g = _check_peer(src, group)
    _need_world("irecv")
    return _P2PRequest(dist.irecv(_raw(tensor), src, group=g.pg), src, True)


def barrier(group=None):
    g = _get_group(group)
    if not _solo(g):
        kw = {}
        if get_backend(g) == "nccl":
            from .env import get_device
            kw["device_ids"] = [get_device().index or 0]
        _run("barrier", g, [], lambda: dist.barrier(group=g.pg, **kw))
    elif torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return _Done()


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the work queued on ``tensor``'s device has run."""
    t = _raw(tensor)
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def destroy_process_group(group=None):
    global _default_group
    from . import comm_plane
    comm_plane.drain()
    if group is None:
        _default_group = None
        if dist.is_initialized():
            dist.destroy_process_group()
    elif group.pg is not None:
        dist.destroy_process_group(group.pg)


class P2POp:
    """One element of a ``batch_isend_irecv`` schedule: ``op`` is
    ``isend`` or ``irecv``."""

    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Post a batch of sends and receives together (one
    ``torch.distributed.batch_isend_irecv``); returns their requests."""
    if not p2p_op_list:
        return []
    _need_world("batch_isend_irecv")
    ops = []
    for op in p2p_op_list:
        g = _check_peer(op.peer, op.group)
        fn = dist.isend if op.op in (isend, send) else dist.irecv
        ops.append(dist.P2POp(fn, _raw(op.tensor), op.peer, group=g.pg))
    works = dist.batch_isend_irecv(ops)
    return [_P2PRequest(w, op.peer, op.op in (irecv, recv))
            for w, op in zip(works, p2p_op_list)]
