"""``GradScaler``: dynamic loss scaling (upstream
``python/paddle/amp/grad_scaler.py``).

Counterpart: ``paddle_tpu/amp/grad_scaler.py``, in its arithmetic:

- ``scale(loss)`` multiplies by the scale;
- ``unscale_`` multiplies every gradient by 1 / scale cast to the
  gradient's dtype (gradients keep their dtypes) and folds one all-finite
  flag over all of them: one host sync a step, not one a parameter;
- ``step`` skips the optimizer's update when a gradient is not finite,
  then ``update`` applies the dynamic rule: after ``decr_every_n_nan_or_inf``
  bad steps the scale is multiplied by ``decr_ratio`` (never below 1.0),
  after ``incr_every_n_steps`` good ones by ``incr_ratio``.
- bf16 passes through: scale 1, no inf check, a plain ``step``.
  ``_passthrough`` reads the ambient ``get_amp_dtype()``, which is
  "float32" outside an ``auto_cast`` block, so the bf16 pass-through
  holds only inside one: the reference's rule, copied as it is.

``unscale_`` runs the optimizer boundary's pre-step hooks first
(``optimizer.optimizer.run_pre_step_hooks``).
"""
from __future__ import annotations

import torch

from .auto_cast import get_amp_dtype


def _unscale_all(grads, inv):
    """Every gradient times ``inv`` in its own dtype, and one all-finite
    flag over the results (a device bool)."""
    out = [g * inv.to(g.dtype) for g in grads]
    ok = torch.stack([torch.isfinite(g).all() for g in out]).all()
    return out, ok


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = bool(enable)
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def _passthrough(self):
        return (not self._enable) or get_amp_dtype() == "bfloat16"

    def scale(self, var):
        if self._passthrough():
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        from ..optimizer.optimizer import run_pre_step_hooks
        run_pre_step_hooks()
        if self._passthrough():
            return
        params = [p for p in optimizer._parameter_list()
                  if p.grad is not None]
        if not params:
            self._found_inf = False
            return
        inv = torch.tensor(1.0 / self._scale, dtype=torch.float32,
                           device=params[0].grad.device)
        with torch.no_grad():
            grads, ok = _unscale_all([p.grad for p in params], inv)
        for p, g in zip(params, grads):
            p.grad = g
        self._found_inf = not bool(ok)

    def step(self, optimizer):
        if self._passthrough():
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, loss):
        self.step(optimizer)

    def update(self):
        if self._passthrough() or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
