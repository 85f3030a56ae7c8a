"""``Model``: the high-level training API (counterpart: ``paddle_tpu/hapi/
model.py``).

``fit`` trains through the port's ``jit.CompiledTrainStep`` (forward,
loss, backward and update as one step, AMP O2 when ``prepare`` asks for
it), built once per ``prepare``; ``steps_per_execution=K`` runs K
batches of one shape as one ``run_steps`` block, a ragged tail batch by
batch. Without a loss, or with ``update=False``, ``train_batch`` runs the
eager ``backward`` (and ``step``) instead. Batches come from the port's
``io.DataLoader`` as CPU tensors and are moved to the network's device
here, one copy a batch (one a block under ``steps_per_execution``).

Multi-process (a world of more than one rank, ``init_parallel_env``
under the launcher or ``spawn``): the train loader is a
``DistributedBatchSampler`` over the rank's share with ``drop_last``
forced, so every rank takes the same number of steps; the eval and
predict loaders give every rank the whole set in order (``shuffle`` is
refused with a warning), so every rank computes the same metrics, while
the train metrics are each rank's own. The gradients are averaged
across the ranks before the clip and the update, in
``CompiledTrainStep``. Under a fleet mesh (``fleet.init``, with
``fleet.distributed_model`` / ``distributed_optimizer``) the train
loader is sharded over the data axes only (dp x sharding): the ranks of
one mp group take the same batches. ``save`` writes ``path.pdparams``
and ``path.pdopt`` through ``paddle.save`` and ``load`` reads them back
in place; ``save(training=False)`` writes an inference export through
``jit.save``. When the optimizer's learning rate is
an ``LRScheduler``, ``fit`` steps it once per epoch, after the epoch's
batches and before the evaluation, as the reference does (the
``LRScheduler`` callback can step it per batch as well).

Over a ``PipelineParallel`` in one process, ``fit``, ``evaluate`` and
``predict`` run the network as the reference does: ``network(*ins)`` is the
whole ``PipelineLayer`` through ``PipelineParallel.forward``, compiled into
the ``CompiledTrainStep`` like any other layer. Where the pp group spans
processes (each rank holds one stage's segment) that would take one
segment for the whole network, so it raises (ROADMAP A7).
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..io import DataLoader
from ..optimizer.lr import LRScheduler as LRSchedulerBase
from .callbacks import CallbackList


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        from ..distributed.fleet.meta_parallel.pipeline_parallel import \
            PipelineParallel
        if isinstance(network, PipelineParallel) and network._multi:
            raise NotImplementedError(
                "Model over a PipelineParallel whose pp group spans "
                "processes (each rank holds one stage's segment) is not "
                "ported yet (ROADMAP A7); call its train_batch and "
                "eval_batch")
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_configs = None
        self._compiled_step = None
        self.stop_training = False

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        self._amp_configs = amp_configs
        self._compiled_step = None
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def _amp_level(self):
        if isinstance(self._amp_configs, dict):
            return self._amp_configs.get("level", "O0")
        return self._amp_configs or "O0"

    def _ensure_compiled_step(self, n_inputs):
        """The ``CompiledTrainStep`` behind ``fit``, built on first use:
        its function returns (loss, *network outputs) so the metrics can
        read the outputs."""
        if self._compiled_step is not None:
            return self._compiled_step
        from ..jit.train_step import CompiledTrainStep
        net, loss_fn = self.network, self._loss

        def fn(*tensors):
            ins, labs = tensors[:n_inputs], tensors[n_inputs:]
            outs = _to_list(net(*ins))
            loss = loss_fn(*outs, *labs)
            if isinstance(loss, (list, tuple)):
                loss = loss[0]
            return (loss, *outs)

        self._compiled_step = CompiledTrainStep(fn, net, self._optimizer,
                                                amp_level=self._amp_level())
        return self._compiled_step

    # -- batch-level API -----------------------------------------------------
    def _device(self):
        for t in self.network.parameters():
            return t.device
        for t in self.network.buffers():
            return t.device
        return torch.device("cpu")

    def _lift(self, t):
        """A batch field on the network's device."""
        if not torch.is_tensor(t):
            t = torch.from_numpy(np.asarray(t))
        return t.to(self._device())

    def train_batch(self, inputs, labels=None, update=True):
        inputs = [self._lift(t) for t in _to_list(inputs)]
        labels = [self._lift(t) for t in _to_list(labels)]
        self.network.train()
        if update and self._loss is not None:
            out = self._ensure_compiled_step(len(inputs))(*inputs, *labels)
            loss, outs = out[0], list(out[1:])
        else:
            outs = _to_list(self.network(*inputs))
            loss = self._loss(*outs, *labels)
            if isinstance(loss, (list, tuple)):
                loss = loss[0]
            loss.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
        metrics = self._update_metrics(outs, labels)
        res = [float(loss)]
        return res + metrics if metrics else res

    def _update_metrics(self, outs, labels):
        res = []
        for m in self._metrics:
            computed = m.compute(*outs, *labels)
            res.append(m.update(computed[0] if isinstance(
                computed, (list, tuple)) else computed))
        return res

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        inputs = [self._lift(t) for t in _to_list(inputs)]
        labels = [self._lift(t) for t in _to_list(labels)]
        self.network.eval()
        outs = _to_list(self.network(*inputs))
        result = []
        if self._loss is not None and labels:
            loss = self._loss(*outs, *labels)
            if isinstance(loss, (list, tuple)):
                loss = loss[0]
            result.append(float(loss))
        metrics = self._update_metrics(outs, labels)
        return result + metrics if metrics else result

    @torch.no_grad()
    def predict_batch(self, inputs):
        inputs = [self._lift(t) for t in _to_list(inputs)]
        self.network.eval()
        return [o.float().cpu().numpy() if o.is_floating_point()
                else o.cpu().numpy() for o in _to_list(self.network(*inputs))]

    # -- loops ---------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle, drop_last,
                     num_workers=0, shard=True):
        """A ``DataLoader`` over ``data``. In a world of more than one
        rank, ``shard`` (training) gives each rank its share with
        ``drop_last`` forced; otherwise every rank gets the whole set in
        order."""
        if data is None or isinstance(data, DataLoader):
            return data
        from ..distributed import get_world_size
        from ..distributed.sharding_api import data_rank_world
        world = get_world_size()
        data_rank, data_world = data_rank_world()
        if data_world > 1 and shard:
            if not drop_last:
                warnings.warn(
                    "multi-process fit forces drop_last=True: a ragged "
                    "final batch cannot tile the mesh batch axes uniformly "
                    "across hosts", UserWarning)
            from ..io import DistributedBatchSampler
            sampler = DistributedBatchSampler(
                data, batch_size, num_replicas=data_world, rank=data_rank,
                shuffle=shuffle, drop_last=True)
            return DataLoader(data, batch_sampler=sampler,
                              num_workers=num_workers)
        if world > 1 and shuffle:
            warnings.warn(
                "multi-process replicated loader ignores shuffle=True "
                "(batch order must be identical on every host)",
                UserWarning)
            shuffle = False
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last)

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)) and len(batch) == 2:
            return _to_list(batch[0]), _to_list(batch[1])
        data = _to_list(batch)
        n_in = len(self._inputs) if self._inputs else 1
        return data[:n_in], data[n_in:]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None,
            steps_per_execution=1):
        """Train for ``epochs`` over ``train_data`` (a dataset or a
        ``DataLoader``), evaluating ``eval_data`` every ``eval_freq``
        epochs. ``steps_per_execution=K`` runs K batches a block: every
        batch still gets its ``on_train_batch_begin``/``end`` with its own
        loss, but after its whole block has run. It needs the compiled
        loss path, so with metrics, without a loss or with gradient
        accumulation it warns and runs one step a block."""
        spe = int(steps_per_execution or 1)
        if spe > 1 and (self._metrics or self._loss is None
                        or accumulate_grad_batches != 1):
            warnings.warn(
                "steps_per_execution > 1 needs the compiled loss path with "
                "no train metrics and no gradient accumulation; running "
                "one step per execution", UserWarning)
            spe = 1
        loader = self._make_loader(train_data, batch_size, shuffle,
                                   drop_last, num_workers)
        eval_loader = self._make_loader(eval_data, batch_size, False, False,
                                        num_workers, shard=False)
        cbks = CallbackList(callbacks, self, verbose=verbose, epochs=epochs,
                            log_freq=log_freq, save_dir=save_dir,
                            save_freq=save_freq,
                            metrics=["loss"] + self._metrics_names())
        cbks.on_begin("train")
        self.stop_training = False
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            if spe > 1:
                logs = self._fit_blocks(loader, cbks, spe, num_iters)
            else:
                logs = {}
                for step, batch in enumerate(loader):
                    cbks.on_batch_begin("train", step, logs)
                    ins, labs = self._split_batch(batch)
                    logs = self._named_logs(self.train_batch(ins, labs))
                    logs["step"] = step
                    logs["batch_size"] = ins[0].shape[0] if ins \
                        else batch_size
                    cbks.on_batch_end("train", step, logs)
                    if num_iters is not None and step + 1 >= num_iters:
                        break
            if isinstance(self._optimizer._learning_rate, LRSchedulerBase):
                self._optimizer._learning_rate.step()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
        cbks.on_end("train", logs)
        return self

    def _fit_blocks(self, loader, cbks, spe, num_iters):
        """One epoch of ``steps_per_execution`` blocks; the last step's
        logs."""
        logs, step, buf = {}, -1, []
        it = iter(loader)
        stop = False
        while not stop:
            batch = next(it, None)
            if batch is not None:
                buf.append(self._split_batch(batch))
            if not (batch is None or len(buf) == spe or (
                    num_iters is not None
                    and step + 1 + len(buf) >= num_iters)):
                continue
            stop = batch is None
            for res, bsz in self._run_block(buf):
                step += 1
                cbks.on_batch_begin("train", step, logs)
                logs = self._named_logs(res)
                logs["step"] = step
                logs["batch_size"] = bsz
                cbks.on_batch_end("train", step, logs)
                if num_iters is not None and step + 1 >= num_iters:
                    stop = True
            buf = []
        return logs

    def _run_block(self, buf):
        """The buffered (inputs, labels) batches as one ``run_steps``
        block when their shapes agree (stacked on the host, one copy to
        the card), else batch by batch. Yields ([loss], batch size) per
        step, in order."""
        if not buf:
            return
        self.network.train()
        rows = [[_as_cpu_tensor(t) for t in ins + labs] for ins, labs in buf]

        def shapes(row):
            return [tuple(t.shape) for t in row]

        if len(rows) > 1 and all(shapes(r) == shapes(rows[0])
                                 for r in rows[1:]):
            step = self._ensure_compiled_step(len(buf[0][0]))
            cols = [self._lift(torch.stack(col)) for col in zip(*rows)]
            losses = step.run_steps(*cols).tolist()
            for (ins, _), loss in zip(buf, losses):
                yield [float(loss)], int(ins[0].shape[0]) if ins else 0
            return
        for ins, labs in buf:
            yield self.train_batch(ins, labs), \
                int(ins[0].shape[0]) if ins else 0

    def _metrics_names(self):
        names = []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _named_logs(self, res):
        logs = {"loss": res[0]}
        for i, m in enumerate(self._metrics, start=1):
            n = m.name()
            names = n if isinstance(n, list) else [n]
            vals = res[i] if i < len(res) else None
            if vals is not None:
                for nm, v in zip(names, vals if isinstance(vals, list)
                                 else [vals]):
                    logs[nm] = v
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        """Mean loss over the batches and each metric's accumulated value,
        in eval mode (batch norms on their running statistics)."""
        loader = self._make_loader(eval_data, batch_size, False, False,
                                   num_workers, shard=False)
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            ins, labs = self._split_batch(batch)
            res = self.eval_batch(ins, labs)
            if res and self._loss is not None:
                losses.append(res[0])
            if num_iters is not None and step + 1 >= num_iters:
                break
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            acc = m.accumulate()
            n = m.name()
            names = n if isinstance(n, list) else [n]
            for nm, v in zip(names, acc if isinstance(acc, list) else [acc]):
                logs[nm] = v
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """The network's outputs per batch as numpy arrays ([batch][output]),
        or with ``stack_outputs`` one array per output."""
        loader = self._make_loader(test_data, batch_size, False, False,
                                   num_workers, shard=False)
        outputs = [self.predict_batch(self._split_batch(batch)[0])
                   for batch in loader]
        if stack_outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- io ------------------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's ``state_dict``) and, with an
        optimizer, ``path.pdopt`` (its ``state_dict``), through
        ``paddle.save``. ``training=False`` exports the network for
        inference through ``jit.save`` at the ``inputs`` given to
        ``Model`` (without them ``jit.save`` raises ValueError)."""
        if not training:
            from ..jit.api import save as jit_save
            jit_save(self.network, path, input_spec=self._inputs)
            return
        from ..framework.io import save as psave
        psave(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            psave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load ``path.pdparams`` into the network in place and, unless
        ``reset_optimizer`` or there is no optimizer or no ``path.pdopt``,
        the optimizer's state. ``skip_mismatch`` leaves out, with a
        warning, the entries whose shape differs from the network's (else
        they raise ValueError)."""
        from ..framework.io import load as pload
        state = pload(path + ".pdparams")
        if skip_mismatch:
            own = self.network.state_dict()
            for k in [k for k, v in state.items() if k in own and
                      tuple(v.shape) != tuple(own[k].shape)]:
                warnings.warn(f"Model.load skips {k}: shape "
                              f"{tuple(state[k].shape)} against the "
                              f"network's {tuple(own[k].shape)}")
                del state[k]
        self.network.set_state_dict(state)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(pload(opt_path))

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)


def _as_cpu_tensor(t):
    return t if torch.is_tensor(t) else torch.from_numpy(np.asarray(t))
