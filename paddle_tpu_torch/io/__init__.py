"""Data loading (counterpart: ``paddle_tpu/io``): the datasets, the
samplers and ``DataLoader`` with worker processes or threads.

Batches are CPU tensors; ``hapi.Model`` moves them to the network's
device. The order of ``RandomSampler`` comes from numpy's global
generator (``np.random.permutation``), as in the reference, so under
one ``np.random.seed`` both packages visit the same samples in the same
order. ``DistributedBatchSampler`` gives each data-parallel rank its
share, index for index as the reference's.
"""
from .dataloader import DataLoader, default_collate_fn, get_worker_info
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "SubsetRandomSampler", "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler",
           "DataLoader", "default_collate_fn", "get_worker_info"]
