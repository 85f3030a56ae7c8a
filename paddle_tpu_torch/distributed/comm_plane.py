"""The comm plane (counterpart: ``paddle_tpu/distributed/comm_plane.py``):
the process's pending collectives. A collective that is one backend call
is launched on ``torch.distributed`` with ``async_op=True``, so a
gradient bucket's all-reduce rides the wire while the backward walk goes
on; the backend runs a process group's collectives in the order they
were launched, so every rank's collectives match in one order with no
thread of the plane's own.

- ``CollectiveWork``: a pending handle over the backend's ``Work``.
  ``wait(timeout)`` honours its deadline (``P2PTimeout``); an error of
  the collective is raised on the waiter; once it landed the backend's
  ``wait`` orders the current stream after it, then the work's ``then``
  (AVG's division, a bucket's copy into ``.grad``) runs once, on the
  thread that waits first; ``result()`` is ``then``'s value.
- ``CommPlane``: the pending works, ``drain(timeout)`` (oldest first) and
  ``stats()`` with the reference's meanings: ``works``, ``comm_ms`` (each
  work from its launch, or the landing of the work launched before it if
  that is later, to its own landing, and nothing if it landed first: the
  reference's worker runs them one after the other in launch order),
  ``exposed_ms`` (the sum of the time callers blocked in ``wait``
  or ``drain``, each wait up to the landing it waited for) and
  ``overlap_efficiency`` (the hidden share). A work lands when the
  backend completes its future: on gloo when the host's collective has
  run, on NCCL when the collective is queued on NCCL's stream, so on NCCL
  ``comm_ms`` is the launch's cost, not the card's (ROADMAP C).
- A collective of several backend calls (the quantized schedule) runs at
  once on the caller's thread; all its time is comm and exposed.
- The plane meters with its ``clock`` (``CommPlane(clock=...)``; by
  default ``substrate.SYSTEM_CLOCK``, whose ``monotonic_ns`` is the
  steady clock), so a test can drive the meters from a clock of its own.
  Deadlines stay on the steady clock: they bound real waits.
- ``get_plane()`` makes the process's plane and registers ``drain`` as an
  optimizer pre-step hook: ``Optimizer.step``, ``clear_grad`` and
  ``GradScaler.unscale_`` never read a gradient a bucket still rewrites.
- ``reduce_array``: the one home of the all-reduce the collective API and
  the bucket reducer share: fp32 over ``torch.distributed`` with AVG as
  SUM / n, or the two-phase quantized schedule of ``comm_quant``.
- ``async_all_gather`` and ``async_reduce_scatter``: ZeRO's parameter
  gathers and gradient reduce-scatters, launched and metered the same
  way. A backend work with no future (gloo's reduce-scatter) lands when
  its first waiter's ``wait`` returns.

- The pipeline's stage-boundary transport: ``pp_send`` (``pp_send_fwd``,
  ``pp_send_bwd``) and ``pp_recv``, between adjacent stages' global
  ranks. A send is a pending work; a receive is pending too, and its
  result is the tensor. Every message is a fixed header (its (kind,
  microbatch) tag, dtype code, sender and dims; ``_HEADER_LEN`` int64)
  and then its payload, so the receiver learns the shape from the
  header. A receive that pops another tag raises
  ``PipelineWireMismatch``. On a gloo group a CUDA tensor travels through
  the host (gloo moves no CUDA tensor point to point; the copy to the
  host waits for the card's queued work), on NCCL and for CPU tensors as
  it is: chosen by backend and device, as ``sep_transport`` chooses.
  Each send and receive is one work of the plane; ``pp_stats()`` counts
  their messages and bytes.
"""
from __future__ import annotations

import collections
import math
import os
import threading
import time

import torch
import torch.distributed as dist

_PLANE = None
_PLANE_LOCK = threading.Lock()


def _system_clock():
    from .substrate import SYSTEM_CLOCK
    return SYSTEM_CLOCK


def _p2p_timeout():
    from .collective import default_p2p_timeout
    return default_p2p_timeout()


def _timeout_error(what, timeout):
    from .collective import P2P_TIMEOUT_ENV, P2PTimeout
    return P2PTimeout(
        f"{what} exceeded the {timeout}s deadline ({P2P_TIMEOUT_ENV}; "
        "0 disables): a peer is dead, wedged, or never launched its "
        "matching collective")


class CollectiveWork:
    """A launched collective, pending until the backend completes it."""

    __slots__ = ("label", "_work", "_then", "_done", "_exc", "_result",
                 "_plane", "_prev", "_t_launch", "_t_end", "_observed",
                 "_settled", "_lock", "_no_future")

    def __init__(self, label, plane=None, work=None, then=None,
                 t_launch=None, result=None, prev=None):
        self.label = label
        self._work = work
        self._then = then
        self._result = result
        self._exc = None
        self._plane = plane
        self._prev = prev               # the work launched before it
        self._observed = False
        self._settled = work is None
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._t_launch = t_launch if t_launch is not None else \
            self._clock().monotonic_ns()
        self._t_end = None
        self._no_future = False
        if work is None:
            self._t_end = self._t_launch
            self._done.set()
            return
        try:
            fut = work.get_future()
        except RuntimeError:
            # a backend work without a future (gloo's reduce-scatter):
            # it lands when a waiter's wait returns
            self._no_future = True
            return
        fut.add_done_callback(self._landed)

    def _landed(self, fut):
        """The backend's completion (on its thread): stamp and meter it."""
        try:
            fut.value()
        except Exception as e:  # noqa: BLE001 -- raised on the waiter (wait, drain), not on the backend's thread
            self._exc = e
        self._plane._landed(self, self._plane.clock.monotonic_ns())
        self._done.set()

    def _clock(self):
        return self._plane.clock if self._plane is not None else \
            _system_clock()

    def is_completed(self):
        return self._done.is_set()

    def _await_done(self, timeout):
        """Wait for the landing, metering the blocked time as exposed;
        raise ``P2PTimeout`` past ``timeout``, not the work's error. Then
        settle the work (once)."""
        if self._no_future and not self._done.is_set():
            with self._lock:
                if not self._done.is_set():
                    t0 = self._plane.clock.monotonic_ns()
                    try:
                        self._work.wait()
                    except Exception as e:  # noqa: BLE001 -- raised on the waiter below
                        self._exc = e
                    t1 = self._plane.clock.monotonic_ns()
                    self._plane._landed(self, t1)
                    self._plane._exposed(t1 - t0)
                    self._done.set()
        if not self._done.is_set():
            clock = self._plane.clock
            t0 = clock.monotonic_ns()
            ok = self._done.wait(timeout)
            end = min(clock.monotonic_ns(), self._t_end) if ok \
                else clock.monotonic_ns()
            self._plane._exposed(end - t0)
            if not ok:
                raise _timeout_error(f"collective work '{self.label}'",
                                     timeout)
        with self._lock:
            if self._settled:
                return
            self._settled = True
            if self._exc is None:
                try:
                    self._work.wait()
                    if self._then is not None:
                        self._result = self._then()
                except Exception as e:  # noqa: BLE001 -- raised on every waiter, as the collective's own error is
                    self._exc = e

    def wait(self, timeout=None):
        """Block until the collective landed; ``timeout=None`` means the
        ``PADDLE_P2P_TIMEOUT`` deadline, not forever."""
        if timeout is None:
            timeout = _p2p_timeout()
        self._await_done(timeout)
        self._observed = True
        if self._exc is not None:
            raise self._exc
        return True

    def result(self, timeout=None):
        self.wait(timeout)
        return self._result

    def exception(self):
        return self._exc if self._done.is_set() else None


class CommPlane:
    """The process's pending collectives and their meters."""

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else _system_clock()
        self._lock = threading.Lock()
        self._pending = collections.deque()
        self._work_ns = 0
        self._exposed_ns = 0
        self._works_total = 0
        self._last = None               # the last work launched
        self._pid = os.getpid()

    def launch(self, start, then=None, label="collective",
               span="comm_plane.launch", **attrs):
        """Call ``start()``, which launches one backend collective with
        ``async_op=True`` and returns its ``Work``; the plane owns it from
        then on. ``then()`` runs once it landed, on the waiter's thread."""
        from ..observability import trace as _obs_trace
        t0 = self.clock.monotonic_ns()
        with _obs_trace.span(span, label=label, **attrs):
            work = start()
        with self._lock:
            prev = self._last
        cw = CollectiveWork(label, self, work, then, t_launch=t0, prev=prev)
        with self._lock:
            self._last = cw
            self._works_total += 1
            while self._pending and self._pending[0]._observed:
                self._pending.popleft()     # waited on by its caller
            self._pending.append(cw)
        return cw

    def run_inline(self, fn, label="collective"):
        """Run ``fn`` (several backend calls) now, on this thread, and
        return its completed work; all of its time is comm and exposed."""
        t0 = self.clock.monotonic_ns()
        try:
            result = fn()
        finally:
            t1 = self.clock.monotonic_ns()
            with self._lock:
                self._works_total += 1
                self._work_ns += t1 - t0
                self._exposed_ns += t1 - t0
        return CollectiveWork(label, result=result)

    def _landed(self, work, t):
        with self._lock:
            start, prev = work._t_launch, work._prev
            if prev is not None:        # not landed yet: it ends after t
                start = max(start, t if prev._t_end is None
                            else prev._t_end)
            work._t_end, work._prev = t, None
            self._work_ns += max(t - start, 0)

    def _exposed(self, ns):
        with self._lock:
            self._exposed_ns += max(ns, 0)

    def _exposed_comm(self, ns):
        """A blocking transfer a work's ``then`` made: comm and exposed."""
        with self._lock:
            self._work_ns += max(ns, 0)
            self._exposed_ns += max(ns, 0)

    def pending_count(self):
        """Works launched and not yet drained (or waited on first)."""
        with self._lock:
            return len(self._pending)

    def drain(self, timeout=None):
        """Wait for every outstanding work, oldest first; ``timeout``
        bounds the whole drain (None: ``PADDLE_P2P_TIMEOUT``). An error no
        one waited on is raised here, once."""
        if timeout is None:
            timeout = _p2p_timeout()
        if not self._pending:
            return True
        from ..observability import trace as _obs_trace
        deadline = (time.monotonic() + timeout) if timeout else None
        with _obs_trace.span("comm_plane.drain",
                             pending=len(self._pending)):
            while self._pending:
                work = self._pending[0]
                left = None
                if deadline is not None:
                    left = max(deadline - time.monotonic(), 0.001)
                work._await_done(left)
                with self._lock:
                    self._pending.popleft()
                if work._exc is not None and not work._observed:
                    work._observed = True
                    raise work._exc
        return True

    def stats(self):
        """{'comm_ms', 'exposed_ms', 'works', 'overlap_efficiency'}."""
        with self._lock:
            comm_ms = self._work_ns / 1e6
            exposed_ms = self._exposed_ns / 1e6
            works = self._works_total
        eff = 1.0 - (exposed_ms / comm_ms) if comm_ms > 0 else 1.0
        return {"comm_ms": comm_ms, "exposed_ms": exposed_ms,
                "works": works,
                "overlap_efficiency": max(min(eff, 1.0), 0.0)}

    def reset_stats(self):
        with self._lock:
            self._work_ns = 0
            self._exposed_ns = 0
            self._works_total = 0


def get_plane():
    """The process's plane (a forked child gets a fresh one). Its first
    creation registers the optimizer-boundary drain."""
    global _PLANE
    with _PLANE_LOCK:
        if _PLANE is None or _PLANE._pid != os.getpid():
            _PLANE = CommPlane()
            from ..optimizer.optimizer import register_pre_step_hook
            register_pre_step_hook(drain)
    return _PLANE


def live_plane():
    """The process's plane if one was made, else None."""
    plane = _PLANE
    if plane is None or plane._pid != os.getpid():
        return None
    return plane


def drain(timeout=None):
    """Drain the plane if there is one (the optimizer pre-step hook)."""
    plane = live_plane()
    if plane is not None:
        plane.drain(timeout)
    return True


def reduce_array(t, group, op, quant_cfg=None):
    """All-reduce ``t`` over ``group``: in place in fp32 (the result is
    ``t``), or through the quantized schedule (a new tensor). In a world
    of one process it is ``t`` itself (one codec round trip when
    quantized)."""
    from . import collective as c
    from . import comm_quant as cq
    if quant_cfg is not None and op not in (c.ReduceOp.SUM, c.ReduceOp.AVG):
        raise NotImplementedError(
            "quantized all_reduce supports SUM/AVG only (max/min/prod do "
            "not commute with block-scaled integer accumulation)")
    if not dist.is_initialized() or (quant_cfg is not None
                                     and group.nranks == 1):
        if quant_cfg is not None:
            return cq.quantization_roundtrip(t, quant_cfg)
        return t
    if quant_cfg is not None:
        out = cq.reduce_quantized(t, group, quant_cfg)
        if op == c.ReduceOp.AVG:
            out = out / group.nranks
        return out.to(t.dtype)
    dist.all_reduce(t, op=c._TORCH_OPS[op], group=group.pg)
    if op == c.ReduceOp.AVG:
        c._divide(t, group.nranks)
    return t


def async_all_reduce(tensor, group, op, quant_cfg=None, then=None,
                     label="all_reduce", span="comm_plane.all_reduce",
                     **attrs):
    """``all_reduce(sync_op=False)``: a pending work after which
    ``tensor`` holds the result and ``then(tensor)``, if given, has run.
    fp32 is one backend all-reduce launched now (AVG's division runs at
    the wait); the quantized schedule runs now, on this thread."""
    from . import collective as c

    def settle(out):
        if out is not tensor:
            tensor.copy_(out)
        if then is not None:
            then(tensor)
        return tensor

    if not dist.is_initialized():
        return CollectiveWork(label, result=settle(
            reduce_array(tensor, group, op, quant_cfg)))
    if group.rank < 0:
        return CollectiveWork(f"{label}:non-member")
    if quant_cfg is not None:
        return get_plane().run_inline(
            lambda: settle(reduce_array(tensor, group, op, quant_cfg)),
            label)

    def landed():
        if op == c.ReduceOp.AVG:
            c._divide(tensor, group.nranks)
        return settle(tensor)

    return get_plane().launch(
        lambda: dist.all_reduce(tensor, op=c._TORCH_OPS[op],
                                group=group.pg, async_op=True),
        then=landed, label=label, span=span, nranks=group.nranks, **attrs)


def async_all_gather(outs, tensor, group, label="all_gather",
                     span="comm_plane.all_gather", **attrs):
    """Every rank's ``tensor`` into the list ``outs`` (one tensor like it
    per rank, in rank order) as one backend all-gather launched now; a
    pending work. A group of one rank copies ``tensor``."""
    if not dist.is_initialized() or group.nranks == 1:
        outs[0].copy_(tensor)
        return CollectiveWork(label, result=outs)
    return get_plane().launch(
        lambda: dist.all_gather(outs, tensor, group=group.pg, async_op=True),
        then=lambda: outs, label=label, span=span, nranks=group.nranks,
        **attrs)


def async_reduce_scatter(out, flat, group, op, label="reduce_scatter",
                         span="comm_plane.reduce_scatter", **attrs):
    """Chunk k of ``flat`` (``nranks`` chunks the size of ``out``) reduced
    over the ranks into rank k's ``out``, as one backend reduce-scatter
    launched now (AVG: SUM, then the division once it landed); a pending
    work."""
    from . import collective as c

    def landed():
        if op == c.ReduceOp.AVG and group.nranks > 1:
            c._divide(out, group.nranks)
        return out

    if not dist.is_initialized() or group.nranks == 1:
        out.copy_(flat.reshape(out.shape))
        return CollectiveWork(label, result=out)
    return get_plane().launch(
        lambda: c._reduce_scatter_single(out.view(-1), flat,
                                         op=c._TORCH_OPS[op],
                                         group=group.pg, async_op=True),
        then=landed, label=label, span=span, nranks=group.nranks, **attrs)


# -- the pipeline's stage-boundary transport ----------------------------------
#
# Activations ("fwd"), gradients of a stage's input ("bwd") and the batch
# loss ("loss") between pipeline stages. Messages between one pair of
# ranks on one group are matched in the order they were posted, so the
# schedule's order is the wire's: forward receives are posted at most one
# microbatch ahead, and a backward receive is posted only when its
# backward runs (``fleet/meta_parallel/pipeline_parallel.py``). A gloo
# send returns before its peer posts the receive (the bytes wait in
# gloo's own buffers), so a send never blocks the schedule.

class PipelineWireMismatch(RuntimeError):
    """A pp receive popped a message whose (kind, microbatch) tag is not
    the one the schedule expected: the stages' schedules diverged."""


_PP_KINDS = ("fwd", "bwd", "loss")
_PP_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
              torch.int64, torch.int32, torch.bool, torch.uint8, torch.int8)
_MAX_DIMS = 6
# kind, microbatch, dtype code, sender, ndim, dims
_HEADER_LEN = 5 + _MAX_DIMS
_PP_STATS = {"sends": 0, "recvs": 0, "bytes_sent": 0, "bytes_received": 0}


def pp_stats():
    """{'sends', 'recvs', 'bytes_sent', 'bytes_received'} of this rank's
    stage-boundary messages (header and payload bytes) since the last
    ``reset_pp_stats``."""
    return dict(_PP_STATS)


def reset_pp_stats():
    _PP_STATS.update(sends=0, recvs=0, bytes_sent=0, bytes_received=0)


class _P2PWorks:
    """A message's backend works (header, payload) as one: no future, so
    it lands when its first waiter's ``wait`` returns; a receive's wait
    honours its deadline (``P2PTimeout``)."""

    def __init__(self, works, peer=None, timeout=None):
        self._works = works
        self._peer = peer
        self._timeout = timeout

    def get_future(self):
        raise RuntimeError("a pp message has no future")

    def wait(self):
        """Wait once: a gloo point-to-point work waited on again would
        wait for the next message."""
        from .collective import _wait_recv
        while self._works:
            w = self._works[0]
            if self._peer is None:
                w.wait()
            else:
                _wait_recv(w, self._peer, self._timeout)
            self._works.pop(0)
        return True


def _pp_group(group):
    from .collective import _get_group
    return _get_group(group)


def _pp_staged(group, device):
    from .sep_transport import _stages
    return _stages(group, device)


def pp_send(tensor, dst, kind, mb, group=None):
    """Send ``tensor`` (a stage's activation, the gradient of its input,
    or the loss) for microbatch ``mb`` to global rank ``dst``, tagged
    (``kind``, ``mb``); returns the pending work. The tensor is read
    before this returns when it travels through the host, else when the
    backend sends it (the caller must not write it meanwhile)."""
    import torch.distributed as tdist
    from .collective import _need_world, _raw
    from .env import get_rank
    _need_world("pp_send")
    t = _raw(tensor).detach()
    if t.dim() > _MAX_DIMS:
        raise ValueError(f"pp_send: {t.dim()} dims (at most {_MAX_DIMS})")
    g = _pp_group(group)
    staged = _pp_staged(g, t.device)
    payload = t.contiguous().reshape(-1)
    if staged:
        payload = payload.cpu()
    head = [_PP_KINDS.index(kind), int(mb), _PP_DTYPES.index(t.dtype),
            get_rank(), t.dim()] + list(t.shape) + [0] * (_MAX_DIMS - t.dim())
    header = torch.tensor(head, dtype=torch.int64,
                          device=payload.device)
    nbytes = header.numel() * 8 + payload.numel() * payload.element_size()
    _PP_STATS["sends"] += 1
    _PP_STATS["bytes_sent"] += nbytes

    def start():
        return _P2PWorks([tdist.isend(header, dst, group=g.pg),
                          tdist.isend(payload, dst, group=g.pg)])

    return get_plane().launch(start, label=f"pp.send_{kind}:{mb}",
                              span=f"pp.send_{kind}", peer=dst, mb=int(mb),
                              nbytes=nbytes)


def pp_send_fwd(tensor, dst, mb, group=None):
    """Send microbatch ``mb``'s stage-boundary activation downstream."""
    return pp_send(tensor, dst, "fwd", mb, group)


def pp_send_bwd(tensor, dst, mb, group=None):
    """Send the gradient of microbatch ``mb``'s stage input upstream."""
    return pp_send(tensor, dst, "bwd", mb, group)


def pp_recv(src, kind, mb, timeout=None, group=None, device=None):
    """Receive microbatch ``mb``'s (``kind``) tensor from global rank
    ``src``: the header's receive is posted now, the payload's once the
    header landed; the pending work's ``result()`` is the tensor, on
    ``device`` (default: where the wire leaves it). A popped tag other
    than (``kind``, ``mb``) raises ``PipelineWireMismatch`` on the
    waiter. ``timeout=None``: the ``PADDLE_P2P_TIMEOUT`` deadline."""
    import torch.distributed as tdist
    from .collective import _need_world
    _need_world("pp_recv")
    g = _pp_group(group)
    if timeout is None:
        timeout = _p2p_timeout()
    wire = torch.device("cpu")
    if device is not None and not _pp_staged(g, torch.device(device)):
        wire = torch.device(device)
    header = torch.empty(_HEADER_LEN, dtype=torch.int64, device=wire)

    def start():
        return _P2PWorks([tdist.irecv(header, src, group=g.pg)], src,
                         timeout)

    plane = get_plane()

    def landed():
        head = header.tolist()
        ndim = head[4]
        shape = tuple(head[5:5 + ndim])
        dtype = _PP_DTYPES[head[2]]
        payload = torch.empty(math.prod(shape), dtype=dtype, device=wire)
        t0 = plane.clock.monotonic_ns()
        _P2PWorks([tdist.irecv(payload, src, group=g.pg)], src,
                  timeout).wait()
        plane._exposed_comm(plane.clock.monotonic_ns() - t0)
        _PP_STATS["recvs"] += 1
        _PP_STATS["bytes_received"] += header.numel() * 8 + \
            payload.numel() * payload.element_size()
        tag = (_PP_KINDS[head[0]], head[1])
        if tag != (str(kind), int(mb)):
            raise PipelineWireMismatch(
                f"pp.recv expected ({kind!r}, mb={mb}) from rank {src} "
                f"but popped tag {tag}: stage schedules diverged")
        out = payload.reshape(shape)
        return out if device is None else out.to(device)

    return plane.launch(start, then=landed, label=f"pp.recv_{kind}:{mb}",
                        span="pp.recv", peer=src, kind=str(kind), mb=int(mb))


def prefetched(thunks, depth=1):
    """Yield each thunk's result in order, with the next ``depth`` thunks
    started before it is yielded (the gather-one-layer-ahead schedule): a
    thunk that launches a collective with ``sync_op=False`` returns its
    pending work, which rides the wire meanwhile, and is yielded as the
    work's result."""
    started = collections.deque()

    def value(r):
        return r.result() if isinstance(r, CollectiveWork) else r

    for thunk in thunks:
        started.append(thunk())
        if len(started) > depth:
            yield value(started.popleft())
    while started:
        yield value(started.popleft())
