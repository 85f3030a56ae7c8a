"""Callbacks of ``Model.fit`` (counterpart: ``paddle_tpu/hapi/
callbacks.py``): ``Callback``, ``CallbackList``, ``ProgBarLogger``,
``EarlyStopping``, ``LRScheduler`` (steps the optimizer's scheduler per
batch, ``by_step``, or per epoch, ``by_epoch``) and ``ReduceLROnPlateau``
(the reference's: it scales a float learning rate by ``factor`` after
``patience`` epochs without a better monitored value, and leaves a
scheduler alone) and ``ModelCheckpoint`` (``Model.save`` to
``save_dir/{epoch}`` every ``save_freq`` epochs and to
``save_dir/final`` when training ends) and ``VisualDL`` (scalars of each
training batch appended to ``log_dir/scalars.tsv``)."""
from __future__ import annotations

import numbers
import os
import time

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass


class CallbackList:
    """The callbacks given, with a ``ProgBarLogger`` first when
    ``verbose`` and none was given, and a ``ModelCheckpoint`` last when
    ``save_dir`` is given and none was."""

    def __init__(self, callbacks=None, model=None, **params):
        self.callbacks = list(callbacks or [])
        verbose = params.get("verbose", 2)
        if verbose and not any(isinstance(c, ProgBarLogger)
                               for c in self.callbacks):
            self.callbacks.insert(0, ProgBarLogger(
                params.get("log_freq", 10), verbose=verbose))
        if params.get("save_dir") and not any(
                isinstance(c, ModelCheckpoint) for c in self.callbacks):
            self.callbacks.append(ModelCheckpoint(params.get("save_freq", 1),
                                                  params["save_dir"]))
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call(f"on_{mode}_begin", logs)

    def on_end(self, mode, logs=None):
        self._call(f"on_{mode}_end", logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_begin", step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_end", step, logs)


class ProgBarLogger(Callback):
    """Prints the numeric logs every ``log_freq`` steps and at the end of
    each epoch."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        if self.verbose and step % self.log_freq == 0:
            items = [f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                     if isinstance(v, numbers.Number)]
            rate = (time.time() - self._t0) / max(self.steps, 1)
            print(f"Epoch {self.epoch}: step {step}, "
                  + ", ".join(items) + f", {rate * 1000:.1f} ms/step")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = [f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                     if isinstance(v, numbers.Number)]
            print(f"Epoch {epoch} done: " + ", ".join(items))


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model and self.save_dir and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, f"{epoch}"))

    def on_train_end(self, logs=None):
        if self.model and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Stops ``fit`` once ``monitor`` (or ``eval_<monitor>``) has not
    improved by ``min_delta`` for ``patience`` epochs; "auto" mode
    maximizes a monitor whose name holds "acc" and minimizes others."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.monitor_op = np.greater
        else:
            self.monitor_op = np.less
            self.min_delta *= -1
        self.best = None
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor) or logs.get(f"eval_{self.monitor}")
        if current is None:
            return
        if isinstance(current, list):
            current = current[0]
        if self.best is None or self.monitor_op(current - self.min_delta,
                                                self.best):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping at epoch {epoch}")


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.best = None
        self.wait = 0
        self.min_lr = min_lr

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor) or logs.get(f"eval_{self.monitor}")
        if current is None:
            return
        if isinstance(current, list):
            current = current[0]
        if self.best is None or current < self.best:
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                opt = self.model._optimizer
                try:
                    new_lr = max(opt.get_lr() * self.factor, self.min_lr)
                    opt.set_lr(new_lr)
                except RuntimeError:
                    pass   # a scheduler drives the rate: left alone
                self.wait = 0


class VisualDL(Callback):
    """Scalar logger: appends ``step\tkey\tvalue`` rows, one for each
    number in a training batch's logs, to ``log_dir/scalars.tsv`` (the
    VisualDL package itself is not bundled)."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._step += 1
        with open(os.path.join(self.log_dir, "scalars.tsv"), "a") as f:
            for k, v in (logs or {}).items():
                if isinstance(v, numbers.Number):
                    f.write(f"{self._step}\t{k}\t{v}\n")
