"""Data loading (counterpart: ``paddle_tpu/io``): ``Dataset``,
``TensorDataset``, the samplers and a single-process ``DataLoader``.

Batches are CPU tensors; ``hapi.Model`` moves them to the network's
device. The order of ``RandomSampler`` comes from numpy's global
generator (``np.random.permutation``), as in the reference, so under
one ``np.random.seed`` both packages visit the same samples in the same
order. Worker processes (``num_workers > 0``) and
``DistributedBatchSampler`` are not ported (ROADMAP A6, A7).
"""
from .dataloader import DataLoader, default_collate_fn
from .dataset import Dataset, TensorDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequenceSampler

__all__ = ["Dataset", "TensorDataset", "Sampler", "SequenceSampler",
           "RandomSampler", "BatchSampler", "DataLoader",
           "default_collate_fn"]
