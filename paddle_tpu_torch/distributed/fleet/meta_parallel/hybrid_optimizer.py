"""HybridParallelOptimizer (counterpart: ``paddle_tpu/distributed/fleet/
meta_parallel/hybrid_optimizer.py``; upstream
``hybrid_parallel_optimizer.py``).

The reference's step holds global gradients, so its wrapper is thin. The
port's ranks hold pieces, so ``step`` does what the reference gets for
free: the ZeRO-2/3 gradients averaged onto their rows over the data axes
(the whole gradients are the ``DataParallel``'s of
``fleet.distributed_model``), the global-norm clip across the groups
(``sharding.hybrid_clip``: mp-split gradients summed over mp, replicated
ones once, ZeRO rows over sharding, the one-process
``ClipGradByGlobalNorm`` scale) and the update, rows-wise under ZeRO.
``CompiledTrainStep`` unwraps it and applies the same rules.
"""
from __future__ import annotations

import torch


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy):
        self._inner_opt = getattr(optimizer, "_optim", optimizer)
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    @torch.no_grad()
    def step(self):
        from ....optimizer.optimizer import run_pre_step_hooks
        from .sharding import hybrid_clip, sharded_update, sync_gradients
        run_pre_step_hooks()
        opt = self._inner_opt
        pairs = [(p, p.grad) for p in opt._parameter_list()
                 if p.requires_grad and p.grad is not None]
        if not pairs:
            return
        mesh = self._hcg.mesh
        params, grads = [p for p, _ in pairs], [g for _, g in pairs]
        grads = sync_gradients(params, grads, mesh, sync_plain=False)
        grads = hybrid_clip(opt._grad_clip, params, grads, mesh)
        opt._step_count += 1
        sharded_update(opt, params, grads, opt.get_lr())
