"""The fleet meta-optimizers (counterpart: ``paddle_tpu/distributed/
fleet/meta_optimizers.py``; upstream ``fleet/meta_optimizers/``): each
wraps a port optimizer and delegates every attribute it does not have to
it, so the wrapper stands where the optimizer stood.

- ``GradientMergeOptimizer(inner, k_steps, avg)``: ``step()`` adds each
  trainable parameter's ``.grad`` into a per-parameter sum, in the
  gradient's own dtype; the first k - 1 calls clear ``.grad`` and return
  False, the k-th sets ``.grad`` to the sum (times 1/k with ``avg``),
  runs the inner step and returns True.
- ``LocalSGDOptimizer(inner, k_steps)``: the inner step every call, and
  every k-th call the parameters averaged over the world (flat fp32
  buckets through the comm plane); in a world of one process the sync is
  the identity.
- ``DGCOptimizer(inner, momentum, sparsity, rampup_begin_step)``: Deep
  Gradient Compression. During the first ``rampup_begin_step`` calls the
  gradients are averaged densely; after that each parameter keeps a
  momentum-corrected velocity u and a local accumulation v (u = m·u + g,
  v = v + u), sends the entries of v at or above its k-th largest |v|
  (k = max(⌊numel·(1 − sparsity)⌋, 1), the threshold at least 1e-30),
  keeps the rest of v and u for later, and the sends are averaged over
  the world before the inner step. The mask compares with the k-th
  value, as the reference does, so ties send every tied entry.

Under O2 the inner optimizer keeps fp32 master weights, and LocalSGD
and DGC average the parameters or gradients it reads, as the reference
does: a LocalSGD sync averages the model's parameters, and the next
update writes each rank's own master weight back over the average.
"""
from __future__ import annotations

import torch


def _world_group():
    """The world's group when more than one process runs, else None."""
    import torch.distributed as dist

    from ..collective import _get_group
    if not dist.is_initialized() or dist.get_world_size() < 2:
        return None
    return _get_group()


def _average(tensors):
    """``tensors`` averaged over the world, as flat fp32 buckets."""
    from ..parallel import all_reduce_gradients
    return all_reduce_gradients(list(tensors), _world_group())


class _Wrapper:
    def __init__(self, inner_optimizer):
        self._inner = inner_optimizer

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def clear_grad(self, set_to_zero=True):
        self._inner.clear_grad(set_to_zero)


class GradientMergeOptimizer(_Wrapper):
    """Accumulate ``k_steps`` calls' gradients, apply them once."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        super().__init__(inner_optimizer)
        self.k_steps = int(k_steps)
        self.avg = avg
        self._acc = {}           # id(param) -> merged gradient
        self._count = 0

    @torch.no_grad()
    def step(self):
        params = [p for p in self._inner._parameter_list()
                  if p.requires_grad]
        self._count += 1
        for p in params:
            if p.grad is None:
                continue
            cur = self._acc.get(id(p))
            self._acc[id(p)] = p.grad if cur is None else cur + p.grad
        if self._count < self.k_steps:
            for p in params:
                p.grad = None
            return False
        scale = 1.0 / self.k_steps if self.avg else 1.0
        for p in params:
            merged = self._acc.get(id(p))
            if merged is not None:
                p.grad = merged * scale
        self._inner.step()
        self._acc.clear()
        self._count = 0
        return True


class LocalSGDOptimizer(_Wrapper):
    """Local steps; the parameters averaged over the world every
    ``k_steps`` calls."""

    def __init__(self, inner_optimizer, k_steps=1):
        super().__init__(inner_optimizer)
        self.k_steps = int(k_steps)
        self._count = 0

    def step(self):
        self._inner.step()
        self._count += 1
        if self._count % self.k_steps == 0:
            self._sync_params()

    @torch.no_grad()
    def _sync_params(self):
        if _world_group() is None:
            return
        params = list(self._inner._parameter_list())
        for p, avg in zip(params, _average(params)):
            p.copy_(avg)


class DGCOptimizer(_Wrapper):
    """Top-k gradient sparsification with momentum correction and local
    accumulation."""

    def __init__(self, inner_optimizer, momentum=0.9, sparsity=0.999,
                 rampup_begin_step=0):
        super().__init__(inner_optimizer)
        self.momentum = momentum
        self.sparsity = float(sparsity)
        self.rampup_begin_step = int(rampup_begin_step)
        self._step_count = 0
        self._u = {}   # id(param) -> momentum-corrected velocity
        self._v = {}   # id(param) -> local accumulation

    def _live(self):
        return [p for p in self._inner._parameter_list()
                if p.requires_grad and p.grad is not None]

    def mask(self, v):
        """The entries of ``v`` this step sends: |v| at or above its k-th
        largest |v| (and at least 1e-30)."""
        flat = v.abs().reshape(-1)
        k = max(int(flat.numel() * (1.0 - self.sparsity)), 1)
        thr = torch.maximum(torch.topk(flat, k).values[-1],
                            torch.tensor(1e-30, dtype=flat.dtype,
                                         device=flat.device))
        return (v.abs() >= thr).to(v.dtype)

    @torch.no_grad()
    def step(self):
        multiproc = _world_group() is not None
        self._step_count += 1
        params = self._live()
        if self._step_count <= self.rampup_begin_step:
            # dense exchange during the ramp-up, so replicas never drift
            if multiproc:
                for p, g in zip(params, _average([p.grad for p in params])):
                    p.grad = g
            self._inner.step()
            return
        sends = []
        for p in params:
            g = p.grad
            u = self._u.get(id(p))
            u = g.clone() if u is None else self.momentum * u + g
            v = self._v.get(id(p))
            v = u.clone() if v is None else v + u
            mask = self.mask(v)
            sends.append(v * mask)
            # the sent entries restart; the rest keeps accumulating
            self._v[id(p)] = v * (1 - mask)
            self._u[id(p)] = u * (1 - mask)
        if multiproc:
            sends = _average(sends)
        for p, s in zip(params, sends):
            p.grad = s
        self._inner.step()
