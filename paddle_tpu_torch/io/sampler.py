"""Samplers (counterpart: ``paddle_tpu/io/sampler.py``). The random ones
draw from numpy's global generator, as the reference's do, or from a
``torch.Generator`` where the caller passes one.
``DistributedBatchSampler`` gives each data-parallel rank its share of
the indices, as the reference's does: the same
``np.random.RandomState(epoch)`` permutation on every rank, padded by
wrapping to a multiple of the world, and rank r taking every world-th
index from r; its world and rank default to the port's
``distributed.get_world_size``/``get_rank``."""
from __future__ import annotations

import math

import numpy as np
import torch


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    """A permutation (or, with ``replacement``, draws) from numpy's global
    generator, as in the reference."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """``indices`` in a random order."""

    def __init__(self, indices, generator=None):
        super().__init__()
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        if self.generator is not None:
            order = torch.randperm(len(self.indices),
                                   generator=self.generator).tolist()
            return iter([self.indices[i] for i in order])
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    """``num_samples`` indices drawn with probability proportional to
    ``weights`` (with replacement unless ``replacement=False``)."""

    def __init__(self, weights, num_samples, replacement=True):
        super().__init__()
        self.weights = np.asarray([float(w) for w in weights])
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices from ``sampler`` (or from a
    sequence or random sampler over ``dataset``); the last, shorter list
    is dropped with ``drop_last``."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__()
        if dataset is None and sampler is None:
            raise ValueError("BatchSampler needs a dataset or a sampler")
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Batches of this rank's share of ``dataset`` (upstream
    ``paddle.io.DistributedBatchSampler``). Call ``set_epoch`` each epoch
    for a new shuffle, the same on every rank."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed import get_rank, get_world_size
            num_replicas = num_replicas or get_world_size()
            rank = rank if rank is not None else get_rank()
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n) \
                .tolist()
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
