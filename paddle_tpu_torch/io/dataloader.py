"""DataLoader (counterpart: ``paddle_tpu/io/dataloader.py``): index lists
from a ``BatchSampler``, samples from the dataset, one batch from
``collate_fn``, in the sampler's order.

``default_collate_fn`` stacks the samples' fields into CPU tensors
(numpy arrays and numbers become tensors; tuples, lists and dicts are
collated field by field). Batches stay on the host: ``hapi.Model`` moves
them to the network's device.

Workers, as in the reference:

- ``num_workers > 0`` (with ``use_shared_memory=True``, the default):
  worker processes from the ``spawn`` context (never ``fork``: the
  parent may hold a live CUDA context). Each receives the dataset and
  ``collate_fn`` pickled, hides the card from itself
  (``CUDA_VISIBLE_DEVICES=""``) and returns collated batches over a
  result queue; tensors travel through shared memory (PyTorch's
  multiprocessing reductions). When the dataset, ``collate_fn`` or
  ``worker_init_fn`` cannot be pickled, the loader falls back to
  threads.
- ``use_shared_memory=False``: worker threads over a bounded
  ``queue.Queue`` (the reference's native ``BlockingQueue`` waits for
  ROADMAP A9).

The consumer restores the sampler's order. Every read of a worker's
result waits at most ``timeout`` seconds (300 when ``timeout`` is 0),
and a worker process that dies is reported as soon as it is seen. A
worker's error is re-raised in the consumer (from a process, as
"DataLoader worker {id} failed on batch {i}: ..."). ``worker_init_fn(id)``
runs first in each worker and ``get_worker_info()`` answers there.
An ``IterableDataset`` is read in the calling process. Workers are made
anew for every pass over the loader (``persistent_workers`` is accepted
and, as in the reference, not honoured).
"""
from __future__ import annotations

import multiprocessing as mp
import numbers
import os
import pickle
import queue
import threading
import time

import numpy as np
import torch

from .dataset import IterableDataset
from .sampler import BatchSampler

_DEFAULT_TIMEOUT_S = 300.0
_POLL_S = 1.0


class _WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = threading.local()


def get_worker_info():
    """The calling worker's ``id``, ``num_workers`` and ``dataset``, or
    None outside a worker."""
    return getattr(_worker_info, "info", None)


def _mp_worker_loop(dataset, collate_fn, task_q, result_q, worker_init_fn,
                    wid, num_workers):
    """The body of a worker process (module level: spawn pickles it by
    name)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""   # workers never touch the card
    _worker_info.info = _WorkerInfo(wid, num_workers, dataset)
    if worker_init_fn:
        worker_init_fn(wid)
    while True:
        item = task_q.get()
        if item is None:
            return
        i, indices = item
        try:
            batch = _to_shared(collate_fn([dataset[j] for j in indices]))
        except Exception as e:   # handed to the consumer
            batch = RuntimeError(
                f"DataLoader worker {wid} failed on batch {i}: {e!r}")
        result_q.put((i, batch))


def _to_shared(batch):
    """``batch`` with its tensors moved to shared memory here, so that a
    failure to do so (a full ``/dev/shm``) is this batch's error and not
    a batch silently dropped by the queue's feeder thread."""
    if torch.is_tensor(batch):
        return batch.share_memory_()
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_shared(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_shared(v) for k, v in batch.items()}
    return batch


def default_collate_fn(batch):
    sample = batch[0]
    if torch.is_tensor(sample):
        return torch.stack(batch)
    if isinstance(sample, (np.ndarray, np.generic)):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, numbers.Number):
        return torch.as_tensor(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (str, bytes)):
        return batch
    return torch.as_tensor(np.asarray(batch))


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(prefetch_factor, 2)
        self.return_list = return_list
        self.use_shared_memory = use_shared_memory
        self.timeout = float(timeout) if timeout and timeout > 0 \
            else _DEFAULT_TIMEOUT_S
        self.worker_init_fn = worker_init_fn
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode or (batch_sampler is None
                                   and batch_size is None):
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        # seconds the last pass spent starting its worker processes
        # (pickling the dataset to each included)
        self.worker_start_s = 0.0

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _fetch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.batch_sampler is None:
            return (self.collate_fn([self.dataset[i]])
                    for i in range(len(self.dataset)))
        if self.num_workers == 0:
            return (self._fetch(ix) for ix in self.batch_sampler)
        if self.use_shared_memory:
            return self._iter_multiprocess()
        return self._iter_threaded()

    def _iter_iterable(self):
        buf = []
        for sample in self.dataset:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)

    def _ordered(self, n, get):
        """The n results of ``get() -> (i, batch)`` in index order; an
        exception in place of a batch is raised."""
        pending = {}
        for expect in range(n):
            while expect not in pending:
                i, data = get()
                pending[i] = data
            data = pending.pop(expect)
            if isinstance(data, Exception):
                raise data
            yield data

    def _iter_multiprocess(self):
        """Spawned worker processes; threads when the dataset,
        ``collate_fn`` or ``worker_init_fn`` cannot be pickled."""
        tasks = [list(ix) for ix in self.batch_sampler]
        ctx = mp.get_context("spawn")
        task_q = ctx.Queue()
        result_q = ctx.Queue(maxsize=self.prefetch_factor * self.num_workers)
        workers = [ctx.Process(
            target=_mp_worker_loop,
            args=(self.dataset, self.collate_fn, task_q, result_q,
                  self.worker_init_fn, w, self.num_workers),
            daemon=True) for w in range(self.num_workers)]
        t0 = time.perf_counter()
        if not _start_all(workers):
            yield from self._iter_threaded()
            return
        self.worker_start_s = time.perf_counter() - t0
        for i, indices in enumerate(tasks):
            task_q.put((i, indices))

        def get():
            deadline = time.monotonic() + self.timeout
            while True:
                try:
                    return result_q.get(timeout=min(
                        _POLL_S, max(deadline - time.monotonic(), 0.0)))
                except queue.Empty:
                    dead = [p.exitcode for p in workers
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"DataLoader worker exited unexpectedly (exit "
                            f"codes {dead})") from None
                    if time.monotonic() >= deadline:
                        raise RuntimeError(
                            f"DataLoader timed out: no batch from a worker "
                            f"in {self.timeout} s") from None

        done = False
        try:
            yield from self._ordered(len(tasks), get)
            done = True
        finally:
            # the end-of-work signal only now: a batch's tensors reach
            # the consumer through file descriptors its worker hands
            # over, so a worker lives until every batch is received; a
            # pass left early terminates its workers at once
            for _ in workers:
                task_q.put(None)
            _stop(workers, grace_s=5.0 if done else 0.0)

    def _iter_threaded(self):
        """``num_workers`` threads take index lists in turn and put
        collated batches on a bounded queue."""
        tasks = list(self.batch_sampler)
        out_q = queue.Queue(maxsize=self.prefetch_factor * self.num_workers)
        next_task = iter(enumerate(tasks))
        task_lock = threading.Lock()
        stop = threading.Event()

        def worker(wid):
            _worker_info.info = _WorkerInfo(wid, self.num_workers,
                                            self.dataset)
            try:
                if self.worker_init_fn:
                    self.worker_init_fn(wid)
            except Exception as e:   # handed to the consumer
                _put(out_q, (-1, e), stop)
                return
            while not stop.is_set():
                with task_lock:
                    i, indices = next(next_task, (None, None))
                if i is None:
                    return
                try:
                    data = self._fetch(indices)
                except Exception as e:   # handed to the consumer
                    data = e
                _put(out_q, (i, data), stop)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()

        def get():
            try:
                i, data = out_q.get(timeout=self.timeout)
            except queue.Empty:
                raise RuntimeError(
                    f"DataLoader timed out: no batch from a worker in "
                    f"{self.timeout} s") from None
            if i == -1:
                raise data
            return i, data

        try:
            yield from self._ordered(len(tasks), get)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=1.0)


def _put(q, item, stop):
    """Put ``item`` on the bounded ``q`` unless the consumer has stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


def _start_all(workers):
    """Start the worker processes at once, one thread each: a start
    returns when its worker has read the pickled dataset, which it reads
    after importing this package, so starts in turn would add those
    times up. False (and no worker left running) when the dataset,
    ``collate_fn`` or ``worker_init_fn`` cannot be pickled."""
    failed = []

    def start(p):
        try:
            p.start()
        except Exception as e:   # sorted out below, in the caller's thread
            failed.append(e)

    threads = [threading.Thread(target=start, args=(p,)) for p in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if not failed:
        return True
    _stop([p for p in workers if p.pid is not None], grace_s=0.0)
    for e in failed:
        if not isinstance(e, (pickle.PicklingError, AttributeError,
                              TypeError)):
            raise e
    return False


def _stop(workers, grace_s=5.0):
    """Join the worker processes, terminating those still alive after
    ``grace_s``."""
    deadline = time.monotonic() + grace_s
    for p in workers:
        p.join(timeout=max(deadline - time.monotonic(), 0.0))
    for p in workers:
        if p.is_alive():
            p.terminate()
            p.join(timeout=grace_s)
