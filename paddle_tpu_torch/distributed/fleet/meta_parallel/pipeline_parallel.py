"""The PipelineParallel trainer (counterpart: ``paddle_tpu/distributed/
fleet/meta_parallel/pipeline_parallel.py``; upstream ``fleet/
meta_parallel/pipeline_parallel.py``).

Two execution paths share one schedule vocabulary:

- **One process** (the pp group is not several processes): the schedule
  over microbatches runs every stage's layers here; numerics are those of
  plain gradient accumulation (``_local_train``).
- **Several processes** (``torch.distributed`` is up and the pp group's
  ranks are distinct processes): a real pipeline. ``PipelineLayer.
  shard_to_stage`` keeps this rank's segment (after the whole build, so
  the seeded init matches one process bit for bit), and stage-boundary
  activations and input gradients travel as tagged messages of the comm
  plane (``comm_plane.pp_send_fwd``/``pp_send_bwd``/``pp_recv``) over the
  pp group: a send is pending while the next microbatch computes.

Schedules (``strategy.pipeline_configs["schedule_mode"]``; aliases
``zb``/``zbh1`` for ``zero_bubble``, ``f-then-b`` for ``gpipe``):

- ``1F1B`` (default): stage s runs ``min(pp - 1 - s, m)`` warm-up
  forwards, then one forward and one backward in turn, then drains the
  backwards. Sends are not waited on; a forward receive is posted one
  microbatch ahead, a backward receive only when its backward runs (the
  two rules of ``docs/PIPELINE.md``, "Wire plane").
- ``zero_bubble``: each backward runs under ``autograd.
  deferred_leaf_grads``: the walk (B) accumulates nothing of the stage's
  parameters, and a tensor hook on the stage input sends its gradient
  upstream the moment the walk computes it; then ``flush()`` (W)
  accumulates the parameters' gradients. ``_last_schedule`` records
  ('B', k) then ('W', k).
- ``gpipe``: every forward, then every backward, with every send waited
  on at once.

``_last_schedule`` holds the executed (F|B|W, microbatch) order and
``_last_max_inflight`` the most microbatch graphs alive at once. The loss
is accumulated on the device; ``train_batch`` reads nothing back itself
(the last stage's loss goes to every other stage as a message, which on a
gloo group of CUDA tensors passes through the host). With a data axis
(dp x sharding above 1), each stage's gradients are averaged over it
before the update. The ``pp.fwd``/``pp.bwd``/``pp.w`` spans go through
``observability/trace.py``.
"""
from __future__ import annotations

import torch

from ....autograd import tape as tape_mod
from ....nn.layer.layers import Layer
from ....observability import trace
from ....ops.dispatch import unwrap
from ...collective import _like
from .pp_layers import PipelineLayer

_SCHEDULE_ALIASES = {
    "1f1b": "1f1b", "zero_bubble": "zero_bubble", "zb": "zero_bubble",
    "zbh1": "zero_bubble", "gpipe": "gpipe", "f-then-b": "gpipe",
}


class MicroBatchSplitError(ValueError):
    """The batch dimension does not divide ``accumulate_steps``: an uneven
    split would desynchronize the per-rank schedules."""


class PipelineSpecMismatch(RuntimeError):
    """A stage-boundary tensor disagreed with the spec agreed at wiring
    time (the first microbatch): shapes and dtypes are fixed per boundary,
    not renegotiated per send."""


class PipelineParallel(Layer):
    def __init__(self, layers, hcg, strategy):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        pcfg = dict(strategy.pipeline_configs) if strategy else {}
        self._micro_batch_size = int(pcfg.get("micro_batch_size", 1))
        self._acc_steps = int(pcfg.get("accumulate_steps", 1))
        mode = str(pcfg.get("schedule_mode", "1F1B")).lower()
        if mode not in _SCHEDULE_ALIASES:
            raise ValueError(
                f"unknown pipeline schedule_mode {mode!r}; expected one "
                f"of {sorted(set(_SCHEDULE_ALIASES))}")
        self._schedule_mode = _SCHEDULE_ALIASES[mode]
        self._pp = hcg.get_pipe_parallel_world_size() if hcg else 1
        self._stage = hcg.get_stage_id() if hcg else 0
        self._last_schedule = []
        self._last_max_inflight = 0
        self._boundary_spec = {"in": None, "out": None}
        self._multi = self._is_cross_process()
        if self._multi:
            layers.shard_to_stage(self._stage)
            for p in layers.parameters():
                p._pp_stage = self._stage
            self._group = hcg.get_pipe_parallel_group()
            self._prev = hcg.get_pipe_prev_rank()
            self._next = hcg.get_pipe_next_rank()
            self._last_stage_rank = hcg.get_rank_at_stage(self._pp - 1)
        params = list(layers.parameters())
        self._device = params[0].device if params else torch.device("cpu")

    def _is_cross_process(self):
        """True when ``torch.distributed`` is up and the pp group's ranks
        are distinct processes (otherwise one process owns every stage and
        runs the schedule alone)."""
        import torch.distributed as dist
        if self._pp <= 1 or self._hcg is None or not dist.is_initialized():
            return False
        ranks = self._hcg.get_pipe_parallel_group().ranks
        return len(set(ranks)) == self._pp and \
            max(ranks) < dist.get_world_size()

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _split_micro(self, data):
        if data is None:
            return [None] * self._acc_steps
        n = int(data.shape[0])
        if n % self._acc_steps != 0:
            raise MicroBatchSplitError(
                f"batch dimension {n} does not divide accumulate_steps="
                f"{self._acc_steps}: every microbatch must be the same "
                "size — pad the batch or change "
                "pipeline_configs.accumulate_steps")
        if self._acc_steps == 1:
            return [data]
        return list(torch.split(data, n // self._acc_steps, dim=0))

    def _agree_spec(self, side, shape, dtype):
        """Hold a boundary tensor to the spec the first microbatch fixed."""
        got = (tuple(int(s) for s in shape),
               str(dtype).replace("torch.", ""))
        spec = self._boundary_spec[side]
        if spec is None:
            self._boundary_spec[side] = got
            return
        if spec != got:
            raise PipelineSpecMismatch(
                f"stage {self._stage} {side}-boundary expects "
                f"shape={spec[0]} dtype={spec[1]} but saw shape={got[0]} "
                f"dtype={got[1]}: boundary specs are agreed once at "
                "wiring time, not per-send")

    def _param_id_set(self):
        return {id(p) for p in self._layers.parameters()}

    # -- training -------------------------------------------------------------
    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One batch through the active schedule, then the update. Returns
        the batch loss (every rank's, in multi-process runs)."""
        x, y = data
        m = self._acc_steps
        if self._multi:
            loss = self._pipe_train(unwrap(x), unwrap(y), m)
            self._average_over_data_axes()
        else:
            loss = self._local_train(unwrap(x), unwrap(y), m)
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return _like(x, loss)

    def _average_over_data_axes(self):
        """Each stage parameter's gradient averaged over the data axes
        (this stage's replicas), as one set of buckets."""
        mesh = getattr(self._hcg, "mesh", None)
        if mesh is None or mesh.degree(*mesh.data_axes) == 1:
            return
        from ...parallel import all_reduce_gradients
        params = [p for p in self._layers.parameters() if p.grad is not None]
        synced = all_reduce_gradients([p.grad for p in params],
                                      mesh.group(*mesh.data_axes))
        for p, g in zip(params, synced):
            p.grad = g

    # -- one process ----------------------------------------------------------
    def _local_train(self, x, y, m):
        micro_x = self._split_micro(x)
        micro_y = self._split_micro(y)
        mode = self._schedule_mode
        warmup = m if mode == "gpipe" else min(max(self._pp - 1, 0), m)
        scale = 1.0 / max(m, 1)
        schedule = []
        inflight = []
        total = None
        max_inflight = 0
        param_ids = self._param_id_set() if mode == "zero_bubble" else None

        def fwd(k):
            nonlocal total, max_inflight
            with trace.span("pp.fwd", mb=k, stage=self._stage):
                out = self._layers(micro_x[k])
                loss = self._layers._loss_fn(out, micro_y[k])
            schedule.append(("F", k))
            inflight.append((k, loss))
            max_inflight = max(max_inflight, len(inflight))
            total = loss.detach() if total is None \
                else total + loss.detach()

        def bwd():
            k, loss = inflight.pop(0)
            if param_ids is not None:
                with tape_mod.deferred_leaf_grads(
                        lambda t: id(t) in param_ids) as d:
                    with trace.span("pp.bwd", mb=k, stage=self._stage):
                        tape_mod.backward(loss * scale)
                schedule.append(("B", k))
                with trace.span("pp.w", mb=k, stage=self._stage):
                    d.flush()
                schedule.append(("W", k))
            else:
                with trace.span("pp.bwd", mb=k, stage=self._stage):
                    tape_mod.backward(loss * scale)
                schedule.append(("B", k))

        for k in range(warmup):
            fwd(k)
        for k in range(warmup, m):
            fwd(k)
            bwd()
        while inflight:
            bwd()
        self._last_schedule = schedule
        self._last_max_inflight = max_inflight
        return total * scale

    # -- several processes ----------------------------------------------------
    def _recv(self, src, kind, k):
        from ... import comm_plane as cp
        return cp.pp_recv(src, kind, k, group=self._group,
                          device=self._device)

    def _send(self, t, dst, kind, k):
        from ... import comm_plane as cp
        return cp.pp_send(t, dst, kind, k, group=self._group)

    def _pipe_train(self, x, y, m):
        stage, pp = self._stage, self._pp
        first, last = stage == 0, stage == pp - 1
        mode = self._schedule_mode
        micro_x = self._split_micro(x) if first else [None] * m
        micro_y = self._split_micro(y) if last else [None] * m
        warmup = m if mode == "gpipe" else min(pp - 1 - stage, m)
        scale = 1.0 / max(m, 1)
        schedule = []
        inflight = []          # (microbatch, input, output or loss)
        pending_recv = {}      # microbatch -> its posted forward receive
        total = None
        max_inflight = 0
        param_ids = self._param_id_set() if mode == "zero_bubble" else None

        def fwd(k):
            nonlocal total, max_inflight
            if first:
                inp = micro_x[k]
            else:
                work = pending_recv.pop(k, None)
                if work is None:
                    work = self._recv(self._prev, "fwd", k)
                inp = work.result()
                self._agree_spec("in", inp.shape, inp.dtype)
                # the next receive is posted before this forward runs:
                # microbatch k+1's wire time overlaps k's compute
                if mode != "gpipe" and k + 1 < m:
                    pending_recv[k + 1] = self._recv(self._prev, "fwd", k + 1)
                inp.requires_grad_(True)
            with trace.span("pp.fwd", mb=k, stage=stage):
                out = self._layers(inp)
                if last:
                    out = self._layers._loss_fn(out, micro_y[k])
            if last:
                total = out.detach() if total is None \
                    else total + out.detach()
            else:
                self._agree_spec("out", out.shape, out.dtype)
                send = self._send(out, self._next, "fwd", k)
                if mode == "gpipe":
                    send.wait()
            inflight.append((k, inp, out))
            schedule.append(("F", k))
            max_inflight = max(max_inflight, len(inflight))

        def send_upstream(k, g, sync):
            self._agree_spec("in", g.shape, g.dtype)
            work = self._send(g, self._prev, "bwd", k)
            if sync:
                work.wait()

        def bwd():
            k, inp, held = inflight.pop(0)
            if last:
                root, seed = held * scale, None
            else:
                seed = self._recv(self._next, "bwd", k).result()
                self._agree_spec("out", seed.shape, seed.dtype)
                root = held
            if param_ids is not None:
                sent = []
                handle = None
                if not first:
                    # the input's gradient leaves mid-walk, before W
                    handle = inp.register_hook(
                        lambda g: sent.append(send_upstream(k, g, False)))
                with tape_mod.deferred_leaf_grads(
                        lambda t: id(t) in param_ids) as d:
                    with trace.span("pp.bwd", mb=k, stage=stage):
                        tape_mod.backward(root, seed)
                if handle is not None:
                    handle.remove()
                    if not sent:   # the walk never reached the input
                        send_upstream(k, torch.zeros_like(inp), False)
                schedule.append(("B", k))
                with trace.span("pp.w", mb=k, stage=stage):
                    d.flush()
                schedule.append(("W", k))
            else:
                with trace.span("pp.bwd", mb=k, stage=stage):
                    tape_mod.backward(root, seed)
                if not first:
                    g = inp.grad if inp.grad is not None \
                        else torch.zeros_like(inp)
                    send_upstream(k, g, mode == "gpipe")
                schedule.append(("B", k))

        for k in range(warmup):
            fwd(k)
        for k in range(warmup, m):
            fwd(k)
            bwd()
        while inflight:
            bwd()
        self._last_schedule = schedule
        self._last_max_inflight = max_inflight
        return self._share_loss(total, scale, m)

    def _share_loss(self, total, scale, m):
        """The last stage's batch loss, sent to every other stage."""
        if self._stage == self._pp - 1:
            batch_loss = total * scale
            for s in range(self._pp - 1):
                self._send(batch_loss, self._hcg.get_rank_at_stage(s),
                           "loss", m)
            return batch_loss
        return self._recv(self._last_stage_rank, "loss", m).result()

    # -- evaluation -----------------------------------------------------------
    def eval_batch(self, data, compute_loss=True):
        """A microbatched forward. One process: the mean of the
        microbatches' losses (or the whole batch's output without a
        loss). Several: the forwards flow through the stages and the last
        stage's batch loss reaches every rank (without a loss, the last
        stage returns the output and the others None)."""
        x, y = data
        x, y = unwrap(x), unwrap(y)
        m = self._acc_steps
        if not self._multi:
            micro_x = self._split_micro(x)
            micro_y = self._split_micro(y)
            if not compute_loss:
                with torch.no_grad():
                    return _like(data[0], self._layers(x))
            total = None
            with torch.no_grad():
                for k in range(m):
                    out = self._layers(micro_x[k])
                    loss = self._layers._loss_fn(out, micro_y[k])
                    total = loss if total is None else total + loss
            return _like(data[0], total * (1.0 / max(m, 1)))
        first = self._stage == 0
        last = self._stage == self._pp - 1
        micro_x = self._split_micro(x) if first else [None] * m
        micro_y = self._split_micro(y) if last else [None] * m
        total = None
        outs = []
        with torch.no_grad():
            for k in range(m):
                if first:
                    inp = micro_x[k]
                else:
                    inp = self._recv(self._prev, "fwd", k).result()
                    self._agree_spec("in", inp.shape, inp.dtype)
                with trace.span("pp.fwd", mb=k, stage=self._stage):
                    out = self._layers(inp)
                if not last:
                    self._agree_spec("out", out.shape, out.dtype)
                    self._send(out, self._next, "fwd", k)
                elif compute_loss:
                    loss = self._layers._loss_fn(out, micro_y[k])
                    total = loss if total is None else total + loss
                else:
                    outs.append(out)
        if not compute_loss:
            from ... import comm_plane as cp
            cp.drain()     # the sends no optimizer step will drain
            if not last:
                return None
            return _like(data[0], torch.cat(outs, dim=0))
        loss = self._share_loss(total, 1.0 / max(m, 1), m)
        from ... import comm_plane as cp
        cp.drain()
        return _like(data[0], loss)
