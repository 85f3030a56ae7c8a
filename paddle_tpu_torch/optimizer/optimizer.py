"""Optimizer base and the concrete optimizers of the training slice
(counterpart: ``paddle_tpu/optimizer/optimizer.py``: ``Optimizer``,
``SGD``, ``Momentum``, ``Adam``, ``AdamW``).

Each optimizer defines one per-parameter update, ``_update(p, g, accs,
lr)``, used both by the eager ``step()`` and by ``CompiledTrainStep``.
Where the JAX package returns new arrays, the port updates ``p`` and the
accumulators in place, in the reference's arithmetic and order of
operations (not ``torch.optim``), so that fp32 runs of the two packages
agree to a few ulps.

Parameters may be given as tensors or as (name, tensor) pairs
(``model.named_parameters()``). A parameter's name is the one from its
pair, else ``getattr(param, "name", None)``; AdamW's
``apply_decay_param_fun`` receives that name or ``""``, and
``state_dict`` keys use it or ``param_<i>``. The learning rate is a
float or an ``LRScheduler`` (``optimizer/lr.py``): ``get_lr`` calls the
scheduler, ``set_lr`` raises under one, and ``state_dict`` carries its
state under ``"LR_Scheduler"``, as in the reference. ``weight_decay`` is a
float or a regularizer (``regularizer.L2Decay``), whose coefficient is
taken, as in the reference.

The optimizer boundary: ``step``, ``clear_grad`` and
``amp.GradScaler.unscale_`` run the pre-step hooks first
(``register_pre_step_hook``), the seam where a gradient-sync plane drains
its in-flight collectives. Nothing registers one yet; with none the cost
is one empty-dict check.
"""
from __future__ import annotations

import torch

from ..ops.dispatch import unwrap
from .lr import LRScheduler

_pre_step_hooks: dict = {}
_next_pre_step_id = 0


def register_pre_step_hook(fn):
    """Register ``fn()`` to run before every ``Optimizer.step`` and
    ``clear_grad`` (and ``GradScaler.unscale_``). Returns a handle with
    ``.remove()``."""
    global _next_pre_step_id
    hid = _next_pre_step_id
    _next_pre_step_id += 1
    _pre_step_hooks[hid] = fn

    class _Handle:
        def remove(self, _hid=hid):
            _pre_step_hooks.pop(_hid, None)

    return _Handle()


def run_pre_step_hooks():
    if _pre_step_hooks:
        for fn in list(_pre_step_hooks.values()):
            fn()


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be given (pass "
                             "model.parameters())")
        self._parameters, self._names = [], []
        for entry in parameters:
            if isinstance(entry, tuple):
                pname, p = entry
            else:
                pname, p = getattr(entry, "name", None), entry
            # a paddle Tensor (the surface's) is updated through its value
            p = getattr(p, "_value", p)
            self._parameters.append(p)
            self._names.append(pname)
        self._name_of = {id(p): pname
                         for p, pname in zip(self._parameters, self._names)}
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if isinstance(weight_decay, (int, float)) or weight_decay is None:
            self._weight_decay = weight_decay
        else:   # an L2Decay-like object
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
        self._accumulators: dict = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when an LRScheduler drives the optimizer")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _parameter_list(self):
        return self._parameters

    # -- accumulators --------------------------------------------------------
    def _get_accumulators(self, p):
        key = id(p)
        if key not in self._accumulators:
            self._accumulators[key] = self._create_accumulators(p)
        return self._accumulators[key]

    def _create_accumulators(self, p):
        return {}

    def _acc_dtype(self, p):
        return torch.float32 if self._multi_precision else p.dtype

    # -- core step -----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        run_pre_step_hooks()
        lr = self.get_lr()
        params_grads = [(p, p.grad) for p in self._parameters
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        for p, g in params_grads:
            if g is not None:
                self._apply(p, g, lr)

    @torch.no_grad()
    def _apply(self, param, g, lr):
        """Update ``param`` in place from its gradient: through an fp32
        master copy when ``multi_precision`` and the parameter is not
        fp32, else directly."""
        accs = self._get_accumulators(param)
        if g.dtype != param.dtype:
            g = g.to(param.dtype)
        if self._multi_precision and param.dtype != torch.float32 and \
                param.is_floating_point():
            master = accs.get("master_weight")
            if master is None:
                master = accs["master_weight"] = param.detach().float()
            self._update_named(param, master, g.float(), accs, lr)
            param.copy_(master)
        else:
            self._update_named(param, param.data, g, accs, lr)

    def _update(self, p, g, accs, lr):
        raise NotImplementedError

    def _update_named(self, param, p, g, accs, lr):
        """Per-parameter update consulted by ``step`` and the train step.
        ``param`` is the parameter object, so AdamW can look up its name
        for the decay exclusion."""
        self._update(p, g, accs, lr)

    def clear_grad(self, set_to_zero=True):
        run_pre_step_hooks()
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    # -- state ---------------------------------------------------------------
    def _state_names(self):
        return [pname or f"param_{i}"
                for i, pname in enumerate(self._names)]

    def state_dict(self):
        state = {}
        for pname, p in zip(self._state_names(), self._parameters):
            for aname, aval in self._accumulators.get(id(p), {}).items():
                state[f"{pname}.{aname}"] = aval
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        state["@step"] = self._step_count
        return state

    @torch.no_grad()
    def set_state_dict(self, state):
        """Take a ``state_dict`` back, as ``paddle.load`` returns it (paddle
        ``Tensor``s or NumPy arrays) or as ``state_dict`` gave it. Each
        accumulator keeps its saved dtype and lands on its parameter's
        device, copied into the existing accumulator when one of that
        shape and dtype is there. As in the reference, keys are matched by
        parameter name or position (``param_<i>``) and a key that names no
        parameter is skipped."""
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        for pname, p in zip(self._state_names(), self._parameters):
            accs = self._accumulators.get(id(p), {})
            loaded = {}
            for key, value in state.items():
                if not key.startswith(pname + "."):
                    continue
                aname = key[len(pname) + 1:]
                src = unwrap(value, device=p.device).detach()
                old = accs.get(aname)
                if old is not None and old.shape == src.shape and \
                        old.dtype == src.dtype:
                    loaded[aname] = old.copy_(src)
                else:
                    loaded[aname] = src.to(device=p.device, copy=True)
            if loaded:
                self._accumulators[id(p)] = {**accs, **loaded}

    # decay helper shared by subclasses -------------------------------------
    def _apply_decay(self, p, g):
        if self._weight_decay:
            return g + self._weight_decay * p
        return g


class SGD(Optimizer):
    def _update(self, p, g, accs, lr):
        g = self._apply_decay(p, g)
        p.sub_(lr * g)


class Momentum(Optimizer):
    """Heavy-ball momentum: ``v = momentum * v + g``, then ``p -= lr * v``
    (``use_nesterov``: ``p -= lr * (g + momentum * v)``), ``g`` with its
    weight decay; the velocity in fp32 under ``multi_precision``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _create_accumulators(self, p):
        return {"velocity": torch.zeros_like(p, dtype=self._acc_dtype(p))}

    def _update(self, p, g, accs, lr):
        g = self._apply_decay(p, g)
        v = accs["velocity"].mul_(self._momentum).add_(g)
        if self._nesterov:
            p.sub_(lr * (g + self._momentum * v))
        else:
            p.sub_(lr * v)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, p):
        dt = self._acc_dtype(p)
        return {"moment1": torch.zeros_like(p, dtype=dt),
                "moment2": torch.zeros_like(p, dtype=dt),
                "beta1_pow": torch.ones((), dtype=dt, device=p.device),
                "beta2_pow": torch.ones((), dtype=dt, device=p.device)}

    def _moments(self, g, accs):
        """m, v and the beta powers advanced one step, in place."""
        b1, b2 = self._beta1, self._beta2
        m = accs["moment1"].mul_(b1).add_((1 - b1) * g)
        v = accs["moment2"].mul_(b2).add_((1 - b2) * torch.square(g))
        b1p = accs["beta1_pow"].mul_(b1)
        b2p = accs["beta2_pow"].mul_(b2)
        return m, v, b1p, b2p

    def _update(self, p, g, accs, lr):
        g = self._apply_decay(p, g)
        m, v, b1p, b2p = self._moments(g, accs)
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        p.sub_(lr * mhat / (torch.sqrt(vhat) + self._epsilon))


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name)
        self._coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _adamw_update(self, p, g, accs, lr, decay):
        if decay and self._coeff:
            p.mul_(1.0 - lr * self._coeff)   # decoupled decay
        m, v, b1p, b2p = self._moments(g, accs)
        # bias corrections folded into scalars, as the reference does:
        # lr * mhat / (sqrt(vhat) + eps) == c3 * m / (sqrt(v) + eps * s2)
        s2 = torch.sqrt(1.0 - b2p)
        c3 = lr * s2 / (1.0 - b1p)
        p.sub_(c3 * m / (torch.sqrt(v) + self._epsilon * s2))

    def _update(self, p, g, accs, lr):
        self._adamw_update(p, g, accs, lr, True)

    def _update_named(self, param, p, g, accs, lr):
        decay = True
        if self._apply_decay_param_fun is not None:
            # reference signature: fn(param_name) -> False to skip decay
            decay = self._apply_decay_param_fun(
                self._name_of.get(id(param)) or "")
        self._adamw_update(p, g, accs, lr, decay)
