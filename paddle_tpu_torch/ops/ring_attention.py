"""Context-parallel attention over a mesh's ``sep`` group (counterpart:
``paddle_tpu/ops/ring_attention.py``).

Each sep rank holds its local shard [b, s_loc, h, d] of q, k and v, as
the reference's functions see theirs inside ``shard_map``; the rank's
index in the group is its place along the sequence.

- ``ring_attention_values``: blockwise softmax accumulation while the kv
  shards rotate around the sep ring (``distributed/sep_transport.py``,
  the ``lax.ppermute`` counterpart). Causal attention with more than one
  rank, an even local shard and sk == sq runs the load-balanced zigzag
  schedule: rank i holds chunks i and 2n-1-i of 2n, so every rotated
  step is half a shard of work (the earlier owner's head half of kv
  against all of q, or all of the later owner's kv against the tail
  half of q). ``zigzag=False`` takes natural contiguous shards and
  shuffles them into that layout and the output back (one exchange each
  way); ``zigzag=True`` trusts the caller's layout. Otherwise the plain
  rotation runs: every step full for non-causal, and for the degenerate
  causal case (one rank, an odd shard) the own chunk causal and only the
  chunks before it.
- ``ulysses_attention_values``: one all-to-all turns the sequence shard
  of q, k and v into a head shard (h/sep heads over the whole sequence),
  ordinary attention runs, and one all-to-all turns it back. The heads
  must divide by the sep degree (``ValueError``).

The blocks run K2 (``ops/cuda_kernels.py`` forward, ``csrc/flash_fwd.cu``)
and, in the backward, K3 when the gate admits every block's shape
(``zigzag_flash_available`` for the zigzag's three block shapes,
``flash_attention_available`` for the ring's); on CPU tensors they run
their plain versions. Other shapes take the dense route: the same
schedule over the plain blocks in fp32, as the reference's dense
fallbacks accumulate in fp32.

Merge, as in the reference: ``exp(m - new_m)·acc + exp(lse_i - new_m)·o_i``
in fp32 with ``l`` clamped at 1e-30; the zigzag's later-owner block
touches the tail half's rows only, which is the reference's constant
−inf lse over the head half.

Gradient: one autograd Function per schedule. The forward walks the
ring and saves the local q, k, v, the merged o and the merged lse
(``m + log l``); the backward walks it again in the same order, each
block running K3 with the merged o and lse (for the later-owner block,
the tail halves of q, o, lse and do). dq accumulates in fp32 on its
rank; dk and dv accumulate in fp32 and travel with k and v, home after n
hops. Every rank makes the same exchanges in the same order whichever
blocks it runs, and memory does not grow with the sep degree (the
reference's ``jax.checkpoint`` of the scan step does that job there).
The gradient is the reference's up to rounding: it differentiates
through the merge with K3's lse cotangent instead.
"""
from __future__ import annotations

import math

import torch

from . import cuda_kernels as ck


def _sep_group(axis_name, group):
    if group is not None:
        return group
    from ..distributed.sharding_api import get_default_mesh
    return get_default_mesh().group(axis_name)


def zigzag_flash_available(q, k, v):
    """Gate for the zigzag schedule's three block shapes (the reference's
    ``zigzag_flash_available`` without its TPU and 512-token checks): the
    own pair causal, the earlier owner's head-half kv against all of q,
    all of the later owner's kv against the tail half of q."""
    if getattr(q, "ndim", 0) != 4 or q.shape[1] % 2:
        return False
    b, s, h, d = q.shape
    half = s // 2
    qh = torch.empty((b, half, h, d), device="meta")
    kvh = torch.empty((k.shape[0], half) + tuple(k.shape[2:]),
                      device="meta")
    return (ck.flash_attention_available(q, k, v, causal=True)
            and ck.flash_attention_available(q, kvh, kvh, causal=False)
            and ck.flash_attention_available(qh, k, v, causal=False))


# -- the blocks ---------------------------------------------------------------
def _block_fwd(q, k, v, causal, scale, kernel):
    """(o, lse) of one block: K2 (its plain version on CPU tensors) on the
    kernel route, else the plain block in fp32."""
    if kernel:
        return ck.flash_attention_fwd(q, k, v, causal, scale)
    return ck.flash_attention_reference(q.float(), k.float(), v.float(),
                                        causal, scale)


def _block_bwd(q, k, v, o, lse, do, causal, scale, kernel):
    """(dq, dk, dv) of one block from the merged o and lse: K3 (its plain
    version on CPU tensors) on the kernel route, else the plain backward
    in fp32."""
    if kernel:
        return ck.flash_attention_bwd(q, k, v, o, lse, do, None, causal,
                                      scale)
    return ck.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), None,
        causal, scale)


class _Merge:
    """The running (m, l, acc) of the blockwise softmax: m and l [b, h, s]
    and acc [b, s, h, d], all fp32."""

    def __init__(self, o, lse):
        self.m = lse.clone()
        self.l = torch.ones_like(lse)
        self.acc = o.float()

    def add(self, o_i, lse_i, rows=None):
        """Merge a block's (o_i, lse_i) into all rows, or into ``rows``
        (a slice of the sequence) alone."""
        sl = slice(None) if rows is None else rows
        m, l = self.m[:, :, sl], self.l[:, :, sl]
        new_m = torch.maximum(m, lse_i)
        alpha = torch.exp(m - new_m)
        beta = torch.exp(lse_i - new_m)
        self.l[:, :, sl] = l * alpha + beta
        self.m[:, :, sl] = new_m
        acc = self.acc[:, sl]
        acc.mul_(alpha.transpose(1, 2)[..., None]).add_(
            o_i.float() * beta.transpose(1, 2)[..., None])

    def result(self, dtype):
        """(o in ``dtype``, the merged lse m + log l)."""
        l = torch.clamp(self.l, min=1e-30)
        o = (self.acc / l.transpose(1, 2)[..., None]).to(dtype)
        return o, self.m + torch.log(l)


def _ring_perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _rotate(ts, group, label):
    """Every tensor of ``ts`` one hop along the ring, in one exchange."""
    from ..distributed import sep_transport
    ring = _ring_perm(group.nranks)
    return sep_transport.permute(list(ts), group, [ring] * len(ts), label)


# -- the plain rotation -------------------------------------------------------
class _RingAttention(torch.autograd.Function):
    """Every rotated block full (non-causal), or for causal the own chunk
    causal and the chunks of lower ranks full; higher ranks' chunks are
    skipped (nothing of them is visible), their rotation kept."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, kernel):
        n, me = group.nranks, group.rank
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        merge = _Merge(*_block_fwd(q, k, v, causal, scale, kernel))
        kv = (k, v)
        for t in range(1, n):
            kv = _rotate(kv, group, "sep.ring_kv")
            if causal and (me - t) % n > me:
                continue
            merge.add(*_block_fwd(q, kv[0], kv[1], False, scale, kernel))
        o, lse = merge.result(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale, ctx.kernel = group, causal, \
            scale, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, scale, kernel = ctx.group, ctx.causal, ctx.scale, \
            ctx.kernel
        n, me = group.nranks, group.rank
        do = do.contiguous()
        dq0, dk0, dv0 = _block_bwd(q, k, v, o, lse, do, causal, scale,
                                   kernel)
        dq, dk, dv = dq0.float(), dk0.float(), dv0.float()
        kv = (k, v)
        for t in range(1, n):
            k_t, v_t, dk, dv = _rotate((*kv, dk, dv), group,
                                       "sep.ring_kv_grad")
            kv = (k_t, v_t)
            if causal and (me - t) % n > me:
                continue
            dq_i, dk_i, dv_i = _block_bwd(q, k_t, v_t, o, lse, do, False,
                                          scale, kernel)
            dq += dq_i
            dk = dk + dk_i
            dv = dv + dv_i
        if n > 1:
            dk, dv = _rotate((dk, dv), group, "sep.ring_grad_home")
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                None, None, None)


# -- the zigzag (load-balanced) causal schedule -------------------------------
class _ZigzagAttention(torch.autograd.Function):
    """The own pair causal (head then tail keeps local order absolute),
    then per rotated step one half-shard block: the earlier owner's head
    half of kv against all of q, or all of a later owner's kv against the
    tail half of q. Inputs and output in the zigzag layout."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale, kernel):
        n, me = group.nranks, group.rank
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        half = q.shape[1] // 2
        merge = _Merge(*_block_fwd(q, k, v, True, scale, kernel))
        kv = (k, v)
        for t in range(1, n):
            kv = _rotate(kv, group, "sep.zigzag_kv")
            if (me - t) % n < me:
                merge.add(*_block_fwd(q, kv[0][:, :half], kv[1][:, :half],
                                      False, scale, kernel))
            else:
                merge.add(*_block_fwd(q[:, half:], kv[0], kv[1], False,
                                      scale, kernel),
                          rows=slice(half, None))
        o, lse = merge.result(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.scale, ctx.kernel = group, scale, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, scale, kernel = ctx.group, ctx.scale, ctx.kernel
        n, me = group.nranks, group.rank
        half = q.shape[1] // 2
        do = do.contiguous()
        dq0, dk0, dv0 = _block_bwd(q, k, v, o, lse, do, True, scale, kernel)
        dq, dk, dv = dq0.float(), dk0.float(), dv0.float()
        kv = (k, v)
        for t in range(1, n):
            k_t, v_t, dk, dv = _rotate((*kv, dk, dv), group,
                                       "sep.zigzag_kv_grad")
            kv = (k_t, v_t)
            if (me - t) % n < me:
                dq_i, dk_i, dv_i = _block_bwd(
                    q, k_t[:, :half], v_t[:, :half], o, lse, do, False,
                    scale, kernel)
                dq += dq_i
                dk[:, :half] += dk_i
                dv[:, :half] += dv_i
            else:
                dq_i, dk_i, dv_i = _block_bwd(
                    q[:, half:], k_t, v_t, o[:, half:], lse[:, :, half:],
                    do[:, half:], False, scale, kernel)
                dq[:, half:] += dq_i
                dk += dk_i
                dv += dv_i
        if n > 1:
            dk, dv = _rotate((dk, dv), group, "sep.zigzag_grad_home")
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                None, None)


def _zigzag_dest(c, n):
    """The rank that holds global chunk c (of 2n) in the zigzag layout."""
    return c if c < n else 2 * n - 1 - c


def _shuffle_to_zigzag(xs, group):
    """Natural contiguous shards (chunks 2d, 2d+1) -> zigzag pairs (d,
    2n-1-d), every tensor of ``xs`` in one exchange: each half-chunk has
    one destination and both half-chunk streams are bijections; the
    receiver's parity says which stream carries its head chunk."""
    from ..distributed import sep_transport
    n, me = group.nranks, group.rank
    perm_a = [(d, _zigzag_dest(2 * d, n)) for d in range(n)]
    perm_b = [(d, _zigzag_dest(2 * d + 1, n)) for d in range(n)]
    halves = []
    for x in xs:
        half = x.shape[1] // 2
        halves += [x[:, :half], x[:, half:]]
    got = sep_transport.ppermute(halves, group, [perm_a, perm_b] * len(xs))
    out = []
    for i in range(len(xs)):
        ra, rb = got[2 * i], got[2 * i + 1]
        out.append(torch.cat([ra, rb] if me % 2 == 0 else [rb, ra], dim=1))
    return out


def _shuffle_from_zigzag(xs, group):
    """The inverse of ``_shuffle_to_zigzag``: each half-chunk back along
    the reversed bijections (the a-stream carried the even global chunk
    of every pair: the head on even ranks, the tail on odd ones)."""
    from ..distributed import sep_transport
    n, me = group.nranks, group.rank
    perm_a = [(_zigzag_dest(2 * d, n), d) for d in range(n)]
    perm_b = [(_zigzag_dest(2 * d + 1, n), d) for d in range(n)]
    sends = []
    for x in xs:
        half = x.shape[1] // 2
        head, tail = x[:, :half], x[:, half:]
        sends += [head, tail] if me % 2 == 0 else [tail, head]
    got = sep_transport.ppermute(sends, group, [perm_a, perm_b] * len(xs))
    return [torch.cat([got[2 * i], got[2 * i + 1]], dim=1)
            for i in range(len(xs))]


def ring_attention_values(q, k, v, axis_name="sep", causal=False,
                          sm_scale=None, zigzag=False, group=None):
    """q, k, v: this rank's shards [b, s_loc, h, d] over the sep group
    (``group``, default the default mesh's ``axis_name`` group). Causal
    with more than one rank, an even shard and sk == sq routes to the
    zigzag schedule (``zigzag``: the shards are already in its layout);
    otherwise the plain rotation."""
    group = _sep_group(axis_name, group)
    n = group.nranks
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if causal and n > 1 and q.shape[1] % 2 == 0 and \
            k.shape[1] == q.shape[1]:
        return _ring_zigzag(q, k, v, group, float(sm_scale), zigzag)
    kernel = ck.flash_attention_available(q, k, v, causal=causal)
    return _RingAttention.apply(q, k, v, group, bool(causal),
                                float(sm_scale), kernel)


def _ring_zigzag(q, k, v, group, sm_scale, pre_permuted):
    if not pre_permuted:
        q, k, v = _shuffle_to_zigzag([q, k, v], group)
    kernel = zigzag_flash_available(q, k, v)
    out = _ZigzagAttention.apply(q, k, v, group, sm_scale, kernel)
    if not pre_permuted:
        out = _shuffle_from_zigzag([out], group)[0]
    return out


def ulysses_attention_values(q, k, v, axis_name="sep", causal=False,
                             sm_scale=None, group=None):
    """Sequence shard -> head shard of q, k and v in one all-to-all
    ([b, s/n, h, d] -> [b, s, h/n, d]), attention over the whole
    sequence (K2/K3 where the gate admits it, else the dense path), and
    the output back in one all-to-all. The heads must divide by the sep
    degree."""
    from ..distributed import sep_transport
    from ..nn.functional.attention import _sdpa_impl
    group = _sep_group(axis_name, group)
    n = group.nranks
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"ulysses attention needs the heads ({q.shape[2]} q, "
            f"{k.shape[2]} kv) to divide by the sep degree {n}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qg, kg, vg = sep_transport.all_to_all_grad([q, k, v], group, 2, 1)
    if ck.flash_attention_available(qg, kg, vg, causal=causal):
        out = ck.flash_attention_values(qg, kg, vg, causal=causal,
                                        sm_scale=sm_scale)
    else:
        out = _sdpa_impl(qg, kg, vg, None, sm_scale, bool(causal))
    return sep_transport.all_to_all_grad([out], group, 1, 2)[0]
