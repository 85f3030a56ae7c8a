"""A single-process DataLoader (counterpart: ``paddle_tpu/io/
dataloader.py``): index lists from a ``BatchSampler``, samples from the
dataset, one batch from ``collate_fn``.

``default_collate_fn`` stacks the samples' fields into CPU tensors
(numpy arrays and numbers become tensors; tuples, lists and dicts are
collated field by field).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .sampler import BatchSampler


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
        if num_workers:
            raise NotImplementedError(
                "DataLoader worker processes are not ported yet (ROADMAP "
                "A6); num_workers must be 0")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = 0
        self.return_list = return_list
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def __iter__(self):
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.collate_fn([self.dataset[i]])
            return
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])
