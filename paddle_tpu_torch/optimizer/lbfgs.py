"""L-BFGS (upstream ``python/paddle/optimizer/lbfgs.py``): the
closure-based quasi-Newton optimizer; ``step(closure)`` re-evaluates the
loss and gradients as the line search probes new points.

Counterpart: ``paddle_tpu/optimizer/lbfgs.py``, in its arithmetic: the
two-loop recursion over flattened parameters and gradients on their
device, the curvature pair kept only when s.y > 1e-10, and the optional
backtracking "strong_wolfe" search. The search is sequential and
host-driven by nature: each probe reads the loss back.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer


def _flatten(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _value(loss):
    """A closure's loss as a Python float."""
    return float(loss.detach()) if torch.is_tensor(loss) else float(loss)


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history_size = history_size
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(f"unsupported line_search_fn {line_search_fn!r}")
        self._line_search_fn = line_search_fn
        self._s_hist = []   # parameter deltas
        self._y_hist = []   # gradient deltas

    def _update(self, p, g, accs, lr):
        raise RuntimeError("LBFGS.step requires a closure")

    def _gather(self):
        params = [p for p in self._parameters if p.requires_grad]
        flat_p = _flatten([p.detach() for p in params])
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        return params, flat_p, _flatten(grads)

    @torch.no_grad()
    def _scatter(self, params, flat):
        off = 0
        for p in params:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape))
            off += n

    def _direction(self, g):
        """Two-loop recursion over the (s, y) history."""
        q = -g
        alphas = []
        for s, y in reversed(list(zip(self._s_hist, self._y_hist))):
            rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((rho, a, s, y))
        if self._y_hist:
            y_last, s_last = self._y_hist[-1], self._s_hist[-1]
            gamma = torch.dot(s_last, y_last) / torch.clamp(
                torch.dot(y_last, y_last), min=1e-10)
            q = q * gamma
        for rho, a, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q

    def step(self, closure):
        """Run up to max_iter L-BFGS iterations; returns the last loss."""
        loss = closure()
        n_eval = 1
        params, flat_p, flat_g = self._gather()
        loss_val = _value(loss)

        for _ in range(self._max_iter):
            if float(flat_g.abs().max()) <= self._tol_grad:
                break
            d = self._direction(flat_g)
            lr = self.get_lr()
            if self._line_search_fn == "strong_wolfe":
                lr, loss_val, flat_p, flat_g, used = self._strong_wolfe(
                    closure, params, flat_p, flat_g, d, lr, loss_val)
                n_eval += used
            else:
                self._scatter(params, flat_p + lr * d)
                self.clear_grad()
                loss = closure()
                n_eval += 1
                _, new_p, new_g = self._gather()
                self._push_pair(new_p - flat_p, new_g - flat_g)
                done = float((new_p - flat_p).abs().max()) <= \
                    self._tol_change
                flat_p, flat_g, loss_val = new_p, new_g, _value(loss)
                if done:
                    break
            if n_eval >= self._max_eval:
                break
        return loss_val

    def _push_pair(self, s, y):
        if float(torch.dot(s, y)) > 1e-10:
            self._s_hist.append(s)
            self._y_hist.append(y)
            if len(self._s_hist) > self._history_size:
                self._s_hist.pop(0)
                self._y_hist.pop(0)

    def _strong_wolfe(self, closure, params, flat_p, flat_g, d, lr,
                      loss0, c1=1e-4, c2=0.9, max_ls=10):
        """Backtracking search that enforces the Armijo and curvature
        conditions, halving the step."""
        g0d = float(torch.dot(flat_g, d))
        used = 0
        best = (lr, loss0, flat_p, flat_g)
        t = lr
        for _ in range(max_ls):
            self._scatter(params, flat_p + t * d)
            self.clear_grad()
            loss = closure()
            used += 1
            _, new_p, new_g = self._gather()
            lv = _value(loss)
            if lv <= loss0 + c1 * t * g0d and \
                    abs(float(torch.dot(new_g, d))) <= c2 * abs(g0d):
                self._push_pair(new_p - flat_p, new_g - flat_g)
                return t, lv, new_p, new_g, used
            if lv < best[1]:
                best = (t, lv, new_p, new_g)
            t *= 0.5
        t, lv, new_p, new_g = best
        self._scatter(params, new_p)
        self._push_pair(new_p - flat_p, new_g - flat_g)
        return t, lv, new_p, new_g, used
