"""CompiledTrainStep: forward, backward, gradient clip and optimizer update
of one training step (counterpart: ``paddle_tpu/jit/train_step.py``).

The JAX package compiles the step into one donated XLA program; the port
runs the same step eagerly. Attention goes through the hand-written
kernels on the card (forward K2, backward K3, through the op
``paddle_tpu_torch::flash_fwd`` of ``ops/cuda_kernels.py``), matrix
products through cuBLAS.
Parameters and optimizer state are updated in place, which is what the
reference's buffer donation achieves. Capturing the step in a CUDA graph
is later work.

``amp_level="O2"`` means what it means in the reference: every floating
parameter is cast to bf16 (or fp16) for the forward, through
``torch.func.functional_call`` over the casts, and the gradients land on
the fp32 parameters through the casts. Buffers and inputs keep their
dtypes. Any other level ("O0", "O1") casts nothing, as in the reference,
whose step applies no cast of its own below O2: ops then follow the
ambient ``amp.auto_cast`` state. This is not ``torch.autocast``, which
computes a different result.

The learning rate is the optimizer's ``get_lr()``, read per call (an
``LRScheduler`` is stepped by the caller between calls) and once per
``run_steps`` block, as in the reference.

``FLAGS_check_nan_inf`` (``utils/flags.py``), read when the step is
built: the per-op scan of ``ops/dispatch.py`` is off inside the step
(the reference traces its step, so no op is scanned there), and each
call folds one isfinite flag per (loss, gradient) before the clip and
reads them back once; when one is set it raises, naming the culprits in
the reference's words, before the update, so the parameters keep their
values (the reference discards the step's outputs). ``run_steps``
refuses the flag, as the reference does: a check after the block would
come after the block's updates.

``set_meter_info(tokens_per_step, flops_per_step)`` feeds the StepMeter
(``observability/perf.py``): with the meter on, each call and each
``run_steps`` block runs inside ``METER.step`` (one attribute check when
it is off).

Data parallelism: when the step's model is a ``distributed.
DataParallel``, or the step runs in a world of more than one rank, each
step averages its gradients across the ranks (the DataParallel's group,
else the world) between the backward and the clip, as flat fp32 buckets
through the comm plane (``distributed.parallel.all_reduce_gradients``).
This is the port's counterpart of the gradient psum XLA puts into the
reference's mesh-sharded step; ``torch.autograd.grad`` leaves ``.grad``
alone, so a DataParallel's own hooks never fire here.

Hybrid parallelism: once a mesh is the default (``fleet.init``,
``sharding_api.set_default_mesh``) with more than one rank, the step
averages over the data axes only (dp x sharding), never over mp, where
the reference commits its placements from the mesh: a whole gradient by
all-reduce, a ZeRO-2 one by reduce-scatter onto its rows, a ZeRO-3 one
(reduce-scattered by its gather's backward) over dp
(``sharding.sync_gradients``). The clip takes its global norm across
the groups (``sharding.hybrid_clip``) and a ZeRO-1/2 parameter is updated
on its rows and gathered (``sharding.sharded_update``). The ZeRO state
travels with the parameters (``p._zero``) and the inner optimizer's
accumulators, so the step may be given the unwrapped net and the inner
optimizer; a ``HybridParallelOptimizer`` or ZeRO wrapper is unwrapped.
On a mesh with a sep axis (context parallelism) each rank's gradients
come from its chunk of the sequence, so ``sync_gradients`` first sums
them over sep; the loss a context-parallel GPT returns is already the
global one.

Pipeline parallelism: the step first calls ``commit_param_shardings`` on
every layer that has it (``GPTForPretrainingPipe``: each pp rank keeps
its stage's stacked rows, and under ``tensor_parallel`` their mp pieces),
as the reference's does before it builds its step (a no-op when
``group_sharded_parallel`` committed them first). ``sync_gradients`` then
sums the parameters outside the pipeline over pp (each rank holds its
share) before ZeRO's average over sharding, and the clip sums each
gradient's squares over the axes it is split on (pp, mp, sharding), per
call and in ``run_steps``, at O0 and O2.

The meta-optimizers: a ``DGCOptimizer`` or ``LocalSGDOptimizer`` is
unwrapped with a ``UserWarning`` naming it, and the step runs its inner
optimizer. A ``GradientMergeOptimizer`` is not unwrapped, as in the
reference: the step updates through it (its attributes reach the inner
optimizer), so every call applies the inner optimizer and its merge
never runs; the step's ``_step_count`` increments land on the wrapper.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed.fleet.meta_parallel.sharding import (hybrid_clip,
                                                        sharded_update,
                                                        sync_gradients)
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from ..observability import perf as _perf
from ..ops.dispatch import op_scan_off
from ..utils.flags import get_flag


def _functional_clip(clip, grads):
    """The train step's clip, as the reference applies it in its step."""
    if clip is None:
        return grads
    if isinstance(clip, ClipGradByValue):
        return [torch.clamp(g, clip.min, clip.max) for g in grads]
    if isinstance(clip, ClipGradByNorm):
        return [clip([(None, g)])[0][1] for g in grads]
    if isinstance(clip, ClipGradByGlobalNorm):
        scale = clip.global_scale(grads)
        return [g * scale.to(g.dtype) for g in grads]
    raise TypeError(f"unsupported grad clip in the train step: {clip!r}")


class _Bound(nn.Module):
    """The step's layers as one module whose forward is the loss function,
    so ``functional_call`` can swap every parameter for its cast."""

    def __init__(self, layers, fn):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.fn = fn

    def forward(self, args, kwargs):
        return self.fn(*args, **kwargs)


_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class CompiledTrainStep:
    """One training step per call.

    ``fn(*batch) -> loss`` (a scalar tensor, or a tuple whose first
    element is the loss) closes over ``layers``. Each call runs the
    forward, the backward (``torch.autograd.grad``, so ``.grad`` is left
    alone), the optimizer's clip and its update, and returns the loss in
    fp32. ``donate`` is accepted for the reference's signature: parameters
    and optimizer state are updated in place either way.
    """

    def __init__(self, fn, layers, optimizer, amp_level="O0",
                 amp_dtype="bfloat16", donate=True):
        if not isinstance(layers, (list, tuple)):
            layers = [layers]
        # DGC and LocalSGD decide per step what crosses the ranks (top-k
        # masks, a k-step parameter sync), which the step's fixed
        # gradient average does not do: the step runs the inner
        # optimizer, with a warning, as the reference's does
        if type(optimizer).__name__ in ("DGCOptimizer",
                                        "LocalSGDOptimizer"):
            import warnings
            warnings.warn(
                f"{type(optimizer).__name__} is an eager-path "
                "meta-optimizer: CompiledTrainStep runs the inner "
                "optimizer only, and the wrapper's gradient "
                "compression/local-step semantics do NOT apply. Use the "
                "eager multi-process path for DGC/LocalSGD, or "
                "GradientMerge (compiled-step aware) instead.",
                UserWarning, stacklevel=2)
            optimizer = optimizer._inner
        # the wrappers of fleet and ZeRO: their rules are the step's own
        optimizer = getattr(optimizer, "_inner_opt", None) or \
            getattr(optimizer, "_optim", optimizer)
        self.fn = fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.compute_dtype = _COMPUTE_DTYPES[amp_dtype]
        # a pipelined model keeps its stage's rows before anything reads
        # the parameters (the reference commits its placements here)
        for layer in layers:
            for m in layer.modules():
                commit = getattr(m, "commit_param_shardings", None)
                if commit is not None:
                    commit()
        self._module = _Bound(layers, fn)
        self._named = list(self._module.named_parameters())
        self.trainable = [p for _, p in self._named if p.requires_grad]
        self._clip = getattr(optimizer, "_grad_clip", None)
        for p in self.trainable:
            optimizer._get_accumulators(p)
        self._n_calls = 0
        self._check_nan = bool(get_flag("FLAGS_check_nan_inf"))
        from ..distributed.parallel import DataParallel
        dp = [m for layer in layers for m in layer.modules()
              if isinstance(m, DataParallel)]
        self._dp = dp[0] if dp else None

    meter_tokens = None
    meter_flops = None

    def set_meter_info(self, tokens_per_step=None, flops_per_step=None):
        """Tokens and FLOPs one step processes, for the StepMeter's
        tokens/s and TF/s (``run_steps`` scales both by K)."""
        self.meter_tokens = tokens_per_step
        self.meter_flops = flops_per_step
        return self

    def _culprits(self, bad):
        names = ["loss"] + [getattr(p, "name", None) or f"param_{i}"
                            for i, p in enumerate(self.trainable)]
        return ", ".join(n for n, b in zip(names, bad) if b)

    def _loss(self, args, kwargs):
        if self.amp_level == "O2":
            cast = {name: p.to(self.compute_dtype) if p.is_floating_point()
                    else p for name, p in self._named}
            out = torch.func.functional_call(self._module, cast,
                                             (args, kwargs))
        else:
            out = self.fn(*args, **kwargs)
        if isinstance(out, (tuple, list)):
            return out[0].float(), tuple(out[1:])
        return out.float(), ()

    def _step(self, args, kwargs, lr, check=False):
        """One step; with ``check``, the nan check raises before the
        update."""
        with op_scan_off():
            loss, aux = self._loss(args, kwargs)
            grads = torch.autograd.grad(loss, self.trainable,
                                        allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                     for g, p in zip(grads, self.trainable)]
            grads = self._sync(grads)
            if check:
                # one fused flag per (loss, grad_i), before the clip, and
                # one host read
                bad = torch.stack([~torch.isfinite(loss).all()] + [
                    ~torch.isfinite(g).all() for g in grads]).tolist()
                if any(bad):
                    raise RuntimeError(
                        "FLAGS_check_nan_inf: non-finite values in "
                        f"compiled train step (step {self._n_calls}): "
                        + self._culprits(bad))
            mesh = self._mesh()
            if mesh is None:
                grads = _functional_clip(self._clip, grads)
                for p, g in zip(self.trainable, grads):
                    self.optimizer._apply(p, g, lr)
            else:
                grads = hybrid_clip(self._clip, self.trainable, grads, mesh)
                sharded_update(self.optimizer, self.trainable, grads, lr)
        return loss.detach(), tuple(a.detach() if torch.is_tensor(a) else a
                                    for a in aux)

    @staticmethod
    def _mesh():
        """The default mesh when it spans more than one rank, else None."""
        from ..distributed.sharding_api import peek_default_mesh
        mesh = peek_default_mesh()
        return mesh if mesh is not None and mesh.size > 1 else None

    def _sync(self, grads):
        """The gradients averaged across the data-parallel ranks (as they
        are in a world of one process); under a mesh, over its data axes
        only, ZeRO-aware."""
        from ..distributed.parallel import all_reduce_gradients
        mesh = self._mesh()
        if mesh is not None:
            mb = self._dp._comm_buffer_size if self._dp is not None else 25
            return sync_gradients(self.trainable, grads, mesh, bucket_mb=mb)
        if self._dp is not None:
            return all_reduce_gradients(grads, self._dp._group,
                                        self._dp._comm_buffer_size)
        return all_reduce_gradients(grads)

    def __call__(self, *args, **kwargs):
        if not _perf.METER.enabled:
            return self._call_impl(args, kwargs)
        with _perf.METER.step(tokens=self.meter_tokens,
                              flops=self.meter_flops, kind="compiled"):
            return self._call_impl(args, kwargs)

    def _call_impl(self, args, kwargs):
        self._n_calls += 1
        loss, aux = self._step(args, kwargs, self.optimizer.get_lr(),
                               self._check_nan)
        self.optimizer._step_count += 1
        return (loss,) + aux if aux else loss

    def run_steps(self, *args, **kwargs):
        """K steps, one per slice of the leading [K, ...] axis of every
        tensor argument (``run_steps(ids_k, labels_k)`` with ids_k
        [K, b, s]), in a Python loop. Returns the [K] fp32 losses. As in
        the reference: the learning rate is read once for the block,
        auxiliary outputs are dropped, and fp32 master weights exist
        before the first step. ``FLAGS_check_nan_inf`` is refused: it needs
        a host check before each step's update."""
        if not _perf.METER.enabled:
            return self._run_steps_impl(args, kwargs, None)
        with _perf.METER.step(kind="compiled_block") as mstep:
            return self._run_steps_impl(args, kwargs, mstep)

    def _run_steps_impl(self, args, kwargs, mstep):
        if self._check_nan:
            raise RuntimeError(
                "run_steps: FLAGS_check_nan_inf needs per-step host "
                "checks; call the step per batch instead")
        leaves = [a for a in (*args, *kwargs.values()) if torch.is_tensor(a)]
        if not leaves:
            raise ValueError("run_steps needs at least one tensor input")
        k = int(leaves[0].shape[0])
        if mstep is not None:
            mstep.set_info(
                k=k,
                tokens=self.meter_tokens * k if self.meter_tokens else None,
                flops=self.meter_flops * k if self.meter_flops else None)
        lr = self.optimizer.get_lr()
        if self.optimizer._multi_precision:
            for p in self.trainable:
                if p.dtype != torch.float32 and p.is_floating_point():
                    accs = self.optimizer._get_accumulators(p)
                    if "master_weight" not in accs:
                        z = getattr(p, "_zero", None)
                        rows = p.detach()
                        if z is not None and tuple(p.shape) == z.full_shape:
                            rows = rows[z.lo:z.hi]   # ZeRO-1/2: its rows
                        accs["master_weight"] = rows.float()
        pick = lambda a, i: a[i] if torch.is_tensor(a) else a  # noqa: E731
        losses = []
        for i in range(k):
            self._n_calls += 1
            loss, _ = self._step(tuple(pick(a, i) for a in args),
                                 {n: pick(a, i) for n, a in kwargs.items()},
                                 lr)
            losses.append(loss)
        self.optimizer._step_count += k
        return torch.stack(losses)
