"""The sep axis's transport: the exchanges context parallelism makes over
a mesh's ``sep`` group (counterparts: the ``lax.ppermute`` and tiled
``lax.all_to_all`` that ``paddle_tpu/ops/ring_attention.py`` calls inside
``shard_map``). Peers are indices into ``group.ranks``.

- ``permute(xs, group, perms)``: tensor ``xs[i]`` moves along ``perms[i]``
  (``(source, destination)`` pairs, a permutation of the group's
  indices), all in one round: each peer's tensors are packed into one
  byte buffer and every send and receive is posted together through one
  ``collective.batch_isend_irecv``, then waited on, so no pair is left
  hanging. A tensor kept by its own rank is not sent; a rank that no
  pair sends to receives zeros (``lax.ppermute``'s rule).
- ``all_to_all(xs, group, split_axis, concat_axis)``: each tensor split
  into ``nranks`` pieces along ``split_axis``, piece p to rank p, the
  received pieces concatenated in rank order along ``concat_axis``
  (``lax.all_to_all(..., tiled=True)``); all tensors in one
  ``collective.alltoall_single``.
- ``loss_sum(x, group)``: the sum over the group of each rank's share of
  a loss; its backward hands each rank the gradient of its own share, so
  each rank differentiates the global loss through its own chunk and the
  parameter gradients are summed over sep afterwards
  (``sharding.sync_gradients``).
- ``ppermute`` and ``all_to_all_grad``: the same as autograd Functions.
  ``ppermute``'s backward sends the gradients along the inverse
  permutations, ``all_to_all_grad``'s runs the transposed all-to-all;
  each backward is again one exchange, so ranks meet in one order.

Host staging: gloo moves no CUDA tensor point to point, so on a gloo
group ``permute`` copies CUDA buffers to the host before posting and the
received ones back after (chosen by the backend and the device, never by
a refused call); on NCCL, and for CPU tensors, buffers go as they are.
Gloo's all-to-all takes CUDA tensors and stages them itself.

``stats()``: the exchanges, the bytes this rank sent and the time they
took on the comm plane's clock (on gloo with CUDA tensors the clock
starts after the card has finished the work queued before the exchange,
which the host copy would wait for anyway). Each exchange also counts as
one work of the comm plane (``CommPlane.run_inline``).
"""
from __future__ import annotations

import torch

_ALIGN = 16                      # bytes; each packed tensor starts aligned
_STATS = {"exchanges": 0, "bytes": 0, "ns": 0}


def stats():
    """{'exchanges', 'bytes', 'ms'} since the last ``reset_stats``."""
    return {"exchanges": _STATS["exchanges"], "bytes": _STATS["bytes"],
            "ms": _STATS["ns"] / 1e6}


def reset_stats():
    _STATS.update(exchanges=0, bytes=0, ns=0)


def _nbytes(shape, dtype):
    n = dtype.itemsize
    for s in shape:
        n *= int(s)
    return n


def _padded(nbytes):
    return -(-nbytes // _ALIGN) * _ALIGN


def _pack(tensors):
    """One flat uint8 buffer holding ``tensors`` one after the other, each
    from a 16-byte boundary."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        pad = _padded(b.numel()) - b.numel()
        if pad:
            parts.append(b.new_zeros(pad))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _unpack(buf, specs):
    """The tensors (views of ``buf``) of ``specs``, (shape, dtype) pairs in
    ``_pack``'s layout."""
    out, off = [], 0
    for shape, dtype in specs:
        nb = _nbytes(shape, dtype)
        out.append(buf[off:off + nb].view(dtype).reshape(shape))
        off += _padded(nb)
    return out


def _stages(group, device):
    """True when point-to-point buffers go through the host: a gloo group
    and CUDA tensors."""
    from .collective import get_backend
    return device.type == "cuda" and get_backend(group) == "gloo"


def _metered(group, device, label, sent_bytes, fn):
    """Run ``fn`` as one comm-plane work, timed on the plane's clock."""
    from . import comm_plane
    plane = comm_plane.get_plane()
    if _stages(group, device):
        torch.cuda.current_stream(device).synchronize()
    t0 = plane.clock.monotonic_ns()
    out = plane.run_inline(fn, label).result()
    _STATS["ns"] += plane.clock.monotonic_ns() - t0
    _STATS["exchanges"] += 1
    _STATS["bytes"] += sent_bytes
    return out


def permute(xs, group, perms, label="sep.permute"):
    """``xs[i]`` sent along ``perms[i]`` in one round; returns the
    received tensors (shapes and dtypes of ``xs``; every rank holds
    tensors of the same shapes)."""
    from . import collective as c
    me, n = group.rank, group.nranks
    out = [None] * len(xs)
    sends, recvs = {}, {}
    for i, (x, perm) in enumerate(zip(xs, perms)):
        dst = dict(perm).get(me)
        src = {d: s for s, d in perm}.get(me)
        if dst == me:
            out[i] = x
            continue
        if dst is not None:
            sends.setdefault(dst, []).append(i)
        if src is not None:
            recvs.setdefault(src, []).append(i)
        else:
            out[i] = torch.zeros_like(x)
    if not sends and not recvs:
        return out
    if n > 1 and not c._live():
        raise RuntimeError("sep exchanges need init_parallel_env "
                           "(this process is the whole world)")
    device = xs[0].device
    stage = _stages(group, device)
    send_bufs = {p: _pack([xs[i] for i in idx]) for p, idx in sends.items()}
    sent = sum(b.numel() for b in send_bufs.values())

    def run():
        ops, inbox = [], {}
        for p, buf in send_bufs.items():
            ops.append(c.P2POp(c.isend, buf.cpu() if stage else buf,
                               group.ranks[p], group))
        for p, idx in recvs.items():
            nb = sum(_padded(_nbytes(xs[i].shape, xs[i].dtype))
                     for i in idx)
            inbox[p] = torch.empty(nb, dtype=torch.uint8,
                                   device="cpu" if stage else device)
            ops.append(c.P2POp(c.irecv, inbox[p], group.ranks[p], group))
        for work in c.batch_isend_irecv(ops):
            work.wait()
        return inbox

    inbox = _metered(group, device, label, sent, run)
    for p, idx in recvs.items():
        buf = inbox[p].to(device) if stage else inbox[p]
        for i, t in zip(idx, _unpack(buf, [(xs[i].shape, xs[i].dtype)
                                           for i in idx])):
            out[i] = t
    return out


def all_to_all(xs, group, split_axis, concat_axis, label="sep.all_to_all"):
    """The tiled all-to-all of every tensor of ``xs`` in one exchange."""
    from . import collective as c
    n = group.nranks
    if n == 1:
        return list(xs)
    for x in xs:
        if x.shape[split_axis] % n:
            raise ValueError(
                f"all_to_all: dimension {split_axis} of {tuple(x.shape)} "
                f"does not split over {n} ranks")
    pieces = [list(x.chunk(n, split_axis)) for x in xs]
    specs = [(tuple(p[0].shape), p[0].dtype) for p in pieces]
    inp = torch.cat([_pack([p[r] for p in pieces]) for r in range(n)])
    out = torch.empty_like(inp)
    device = inp.device
    _metered(group, device, label, inp.numel() * (n - 1) // n,
             lambda: c.alltoall_single(out, inp, group=group))
    got = [_unpack(chunk, specs) for chunk in out.chunk(n)]
    return [torch.cat([got[r][i] for r in range(n)], dim=concat_axis)
            for i in range(len(xs))]


def _inverse(perm):
    return [(d, s) for s, d in perm]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, perms, *xs):
        ctx.group, ctx.perms = group, perms
        return tuple(permute(list(xs), group, perms))

    @staticmethod
    def backward(ctx, *grads):
        back = permute(list(grads), ctx.group,
                       [_inverse(p) for p in ctx.perms],
                       label="sep.permute_grad")
        return (None, None) + tuple(back)


def ppermute(xs, group, perms):
    """``permute`` with gradients: the backward sends each gradient along
    the inverse permutation, all in one round."""
    return list(_PPermute.apply(group, [list(p) for p in perms], *xs))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, split_axis, concat_axis, *xs):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return tuple(all_to_all(list(xs), group, split_axis, concat_axis))

    @staticmethod
    def backward(ctx, *grads):
        split_axis, concat_axis = ctx.axes
        back = all_to_all([g.contiguous() for g in grads], ctx.group,
                          concat_axis, split_axis,
                          label="sep.all_to_all_grad")
        return (None, None, None) + tuple(back)


def all_to_all_grad(xs, group, split_axis, concat_axis):
    """``all_to_all`` with gradients: one exchange forward, one back."""
    return list(_AllToAll.apply(group, split_axis, concat_axis, *xs))


class _LossSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        from .collective import all_reduce
        out = x.detach().clone()
        all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def loss_sum(x, group):
    """Each rank's share ``x`` summed over ``group``; the gradient passes
    through to the rank's own share."""
    return _LossSum.apply(x, group)
