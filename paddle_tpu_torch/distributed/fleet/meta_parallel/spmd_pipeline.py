"""The SPMD pipeline over the mesh's pp axis, with explicit ranks
(counterpart: ``paddle_tpu/distributed/fleet/meta_parallel/
spmd_pipeline.py``, which runs it as one compiled program: stacked
weights sharded over 'pp', microbatches rotated through the stages by
``lax.ppermute`` inside a ``lax.scan``).

Each pp rank holds its stage's rows of the stacked weights and runs the
same tick loop; after every tick the state moves one stage on (stage s to
s + 1, the last back to the first) as one exchange of the pp group
(``sep_transport.permute``: its packing, host staging and metering are
not sep-specific).

Two schedules, one loop:

- GPipe (``n_chunks`` 1): a microbatch makes one revolution; a stage
  applies all of its layers each tick. Ticks m + pp - 1; bubble fraction
  (pp - 1) / (m + pp - 1).
- Interleaved (``n_chunks`` v > 1): stage s holds the global chunks s,
  s + pp, ... chunk-major, and a microbatch makes v revolutions, one
  chunk a visit. Ticks m·v + pp - 1 at 1/v of the compute each, so the
  bubble drops v-fold to (pp - 1) / (m·v + pp - 1). Needs m % pp == 0.

The loop is one ``torch.autograd.Function`` (``_TickLoop``), so every rank
meets the same exchanges in the same order in the backward too: its
forward runs each valid tick's chunk under ``enable_grad`` on a detached
input and keeps that tick's graph (with ``remat``, only its input, and
recomputes in the backward: the reference's ``jax.checkpoint``); bubble
ticks compute nothing and exchange zeros, as their outputs are never
read. Its backward walks the ticks in reverse, one exchange each (the
state's gradient to the previous stage), taking each tick's gradients
with ``torch.autograd.grad``. Each rank's forward and backward make
m·v + pp - 1 exchanges of one microbatch's state.

Tensor parallelism inside the pipeline (``spmd_pipeline(param_specs=)``,
the reference's): each leaf's ``Placement`` leads with its stage's rows
over pp and may cut a trailing column or row range over mp, so a rank's
leaves are its stage's rows and mp piece; ``block_fn`` then issues the
mp sums (``text/gpt.py`` ``StackedGPTBlocks``). Those collectives run
inside the tick loop, in its forward, its recompute (``remat``) and its
backward, on every mp rank of a (pp, sharding) coordinate in one order:
the ranks of an mp group share a stage, so they share the schedule. The
exchanges stay over the rank's pp group, the ranks of its (sharding,
sep, mp) coordinate; on a mesh with sep the batch stays split over the
data axes only, as in the reference, so every sep rank pipelines the
whole sequence. The tick loop's graphs keep what they save as it is: a
ZeRO-3 leaf gathered for the step stays whole until the backward (the
loop holds it for its chunks anyway), where ``GroupShardedStage3``'s
hooks would gather it again for every saved product.

``stats()``: the broadcasts of the last stage's output and their
backward all-reduces since ``reset_stats()``, and the ms they took on
the host's clock (each starts after the card finished the work queued
before it). The per-tick exchanges are ``sep_transport.stats()``'s.

Index arithmetic per tick t on stage s (the reference's): tau = t - s,
u = clip(tau, 0, m·v - 1) mod (v·pp), group = clip(...) // (v·pp),
chunk = u // pp, microbatch = group·pp + u mod pp; a fresh microbatch
enters at stage 0's chunk 0, and the last stage's last chunk writes the
finished one.
"""
from __future__ import annotations

import time

import numpy as np
import torch

_STATS = {"collectives": 0, "ns": 0}


def stats():
    """{'collectives', 'ms'} of the last stage's broadcasts and their
    backward all-reduces since the last ``reset_stats``."""
    return {"collectives": _STATS["collectives"], "ms": _STATS["ns"] / 1e6}


def reset_stats():
    _STATS.update(collectives=0, ns=0)


def _timed(t, fn):
    """Run the collective ``fn`` on ``t``, counted and timed."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter_ns()
    fn()
    _STATS["ns"] += time.perf_counter_ns() - t0
    _STATS["collectives"] += 1


def pipeline_ticks(n_microbatch, n_stages, n_chunks=1):
    """Scheduled loop length: m*v + pp - 1."""
    return n_microbatch * n_chunks + n_stages - 1


def bubble_fraction(n_microbatch, n_stages, n_chunks=1):
    """Idle fraction of the schedule (each tick applies
    layers_total/pp/v layers)."""
    ticks = pipeline_ticks(n_microbatch, n_stages, n_chunks)
    return (n_stages - 1) / ticks


def interleave_row_order(total_layers, n_stages, n_chunks):
    """Row permutation handing stage s the chunk-major rows of global
    chunks s, s+pp, s+2*pp, ...:

    new_row[s*v*lpc + c*lpc + l] = old_row[(c*pp + s)*lpc + l]
    """
    if total_layers % (n_stages * n_chunks):
        raise ValueError(
            f"total layers ({total_layers}) must divide by "
            f"pp * n_chunks ({n_stages} * {n_chunks})")
    lpc = total_layers // (n_stages * n_chunks)
    order = np.empty(total_layers, np.int64)
    i = 0
    for s in range(n_stages):
        for c in range(n_chunks):
            for l in range(lpc):
                order[i] = (c * n_stages + s) * lpc + l
                i += 1
    return order


def _tick(t, stage, pp, m, v):
    """(valid, chunk, microbatch) of tick ``t`` on ``stage``."""
    tau = t - stage
    c = min(max(tau, 0), m * v - 1)
    u = c % (v * pp)
    grp = c // (v * pp)
    chunk = u // pp
    mb = min(max(grp * pp + u % pp, 0), m - 1)
    return 0 <= tau < m * v, chunk, mb


def _rotate(x, group, label, backward=False):
    """One exchange: ``x`` to the next stage (the previous one when
    ``backward``); returns what this rank received."""
    from ...sep_transport import permute
    n = group.nranks
    perm = [((i + 1) % n, i) if backward else (i, (i + 1) % n)
            for i in range(n)]
    return permute([x], group, [perm], label=label)[0]


class _TickLoop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block_fn, group, m, v, remat, x, *params):
        pp, stage = group.nranks, group.rank
        rows = params[0].shape[0]
        lpc = rows // v
        micro = x.detach().reshape((m, x.shape[0] // m) + x.shape[1:])
        leaves = [[p.detach()[c * lpc:(c + 1) * lpc].requires_grad_()
                   for p in params] for c in range(v)]
        state = torch.zeros_like(micro[0])
        outbuf = torch.zeros_like(micro)
        kept = []
        for t in range(pipeline_ticks(m, pp, v)):
            valid, chunk, mb = _tick(t, stage, pp, m, v)
            if not valid:
                kept.append(None)
                y = torch.zeros_like(state)
            else:
                x_in = micro[mb] if stage == 0 and chunk == 0 else state
                x_in = x_in.detach().requires_grad_()
                with torch.enable_grad(), \
                        torch.autograd.graph.saved_tensors_hooks(_keep,
                                                                 _keep):
                    y = _apply_chunk(block_fn, leaves[chunk], x_in)
                kept.append((x_in, None if remat else y))
                if stage == pp - 1 and chunk == v - 1:
                    outbuf[mb] = y.detach()
            state = _rotate(y.detach(), group, "pp.permute")
        ctx.block_fn, ctx.group, ctx.m, ctx.v = block_fn, group, m, v
        ctx.leaves, ctx.kept = leaves, kept
        ctx.x_shape = x.shape
        return outbuf.reshape(x.shape)

    @staticmethod
    def backward(ctx, dout):
        group, m, v = ctx.group, ctx.m, ctx.v
        pp, stage = group.nranks, group.rank
        leaves, kept = ctx.leaves, ctx.kept
        d_out = dout.reshape((m, dout.shape[0] // m) + dout.shape[1:])
        d_micro = torch.zeros_like(d_out)
        d_params = [[torch.zeros_like(p) for p in chunk] for chunk in leaves]
        d_next = torch.zeros_like(d_out[0])
        for t in reversed(range(pipeline_ticks(m, pp, v))):
            dy = _rotate(d_next, group, "pp.permute_grad", backward=True)
            valid, chunk, mb = _tick(t, stage, pp, m, v)
            if not valid:
                d_next = torch.zeros_like(dy)
                continue
            if stage == pp - 1 and chunk == v - 1:
                dy = dy + d_out[mb]
            x_in, y = kept[t]
            if y is None:
                with torch.enable_grad():
                    y = _apply_chunk(ctx.block_fn, leaves[chunk], x_in)
            grads = torch.autograd.grad(y, [x_in] + leaves[chunk], dy,
                                        allow_unused=True)
            kept[t] = None
            for acc, g in zip(d_params[chunk], grads[1:]):
                if g is not None:
                    acc += g
            if stage == 0 and chunk == 0:
                d_micro[mb] += grads[0]
                d_next = torch.zeros_like(dy)
            else:
                d_next = grads[0]
        ctx.kept = ctx.leaves = None
        d_x = d_micro.reshape(ctx.x_shape)
        d_p = [torch.cat([d_params[c][i] for c in range(v)])
               for i in range(len(d_params[0]))]
        return (None, None, None, None, None, d_x, *d_p)


def _keep(t):
    return t


def _apply_chunk(block_fn, chunk_params, x):
    """The chunk's layers one after the other."""
    for layer in range(chunk_params[0].shape[0]):
        x = block_fn(tuple(p[layer] for p in chunk_params), x)
    return x


def spmd_pipeline_local(block_fn, local_params, x, n_microbatch, group,
                        n_chunks=1, remat=False):
    """Run this rank's stage of the pipeline.

    ``block_fn(layer_params, x) -> x``: one repeated block (a tuple of
    one layer's tensors). ``local_params``: tensors whose rows
    [n_chunks * layers_per_chunk, ...] are this stage's, chunk-major.
    ``x`` [B, ...]: the whole batch, the same on every stage. Returns
    y [B, ...], valid on the last stage (zeros elsewhere): combine with
    ``broadcast_from_last_stage``."""
    m, v = int(n_microbatch), int(n_chunks)
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"microbatches {m}")
    rows = local_params[0].shape[0]
    if rows % v:
        raise ValueError(f"stage rows {rows} not divisible by chunks {v}")
    return _TickLoop.apply(block_fn, group, m, v, bool(remat), x,
                           *local_params)


class _LastStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        from ...collective import broadcast
        ctx.group = group
        out = y.detach().clone()
        _timed(out, lambda: broadcast(out, src=group.ranks[-1], group=group))
        return out

    @staticmethod
    def backward(ctx, grad):
        from ...collective import all_reduce
        g = grad.contiguous().clone()
        _timed(g, lambda: all_reduce(g, group=ctx.group))
        if ctx.group.rank != ctx.group.nranks - 1:
            g.zero_()
        return g, None


def broadcast_from_last_stage(y, group):
    """The last stage's ``y`` on every pp rank; the backward hands the
    sum of the ranks' gradients to the last stage (the transpose of the
    reference's psum-mask broadcast), zeros to the others."""
    return _LastStage.apply(y, group)


def _local_piece(p, spec):
    """This rank's piece of ``p`` by its placement ``spec``: ``p`` as it
    is when it already has the piece's shape, else cut out of the global
    value."""
    if tuple(p.shape) != spec.global_shape:
        return p
    if len(spec.pieces) == 1:
        return p[tuple(slice(*g) for g in spec.pieces[0][1])]
    return spec.take(p)


def spmd_pipeline(block_fn, stage_params, x, n_microbatch, group,
                  n_chunks=1, remat=False, param_rows=None,
                  param_specs=None):
    """The pipeline over ``group`` (the mesh's pp group): every rank gets
    the last stage's output. ``stage_params``: this stage's rows,
    chunk-major when ``n_chunks > 1`` (``interleave_row_order`` arranges
    the stored rows once). ``param_rows``: the total layer count, checked
    to divide by ``pp * n_chunks``. The interleaved schedule needs
    ``n_microbatch % pp == 0``.

    ``param_specs``: one ``sharding_api.Placement`` per leaf, each leading
    with "pp" on dimension 0 (the reference's ``PartitionSpec``s leading
    with its pp axis); a leaf given whole (its placement's global shape)
    is cut to this rank's piece, its stage's rows and, under tensor
    parallelism, its mp range, and ``block_fn`` then owns the mp sums."""
    pp = group.nranks
    if n_chunks > 1 and n_microbatch % pp:
        raise ValueError(
            f"interleaved schedule needs n_microbatch ({n_microbatch}) "
            f"divisible by pp ({pp})")
    if param_rows is not None and param_rows % (pp * n_chunks):
        raise ValueError(
            f"total layers ({param_rows}) must divide by pp * n_chunks "
            f"({pp} * {n_chunks})")
    if param_specs is not None:
        for spec in param_specs:
            if spec.dim_axes[0][:1] != ("pp",):
                raise ValueError(f"param_specs must lead with 'pp' on dim "
                                 f"0 (got {spec})")
        stage_params = tuple(_local_piece(p, spec) for p, spec in
                             zip(stage_params, param_specs))
    y = spmd_pipeline_local(block_fn, stage_params, x, n_microbatch, group,
                            n_chunks=n_chunks, remat=remat)
    return broadcast_from_last_stage(y, group)
