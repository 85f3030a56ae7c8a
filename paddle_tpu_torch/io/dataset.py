"""Datasets (counterpart: ``paddle_tpu/io/dataset.py``): ``Dataset``,
``IterableDataset``, ``TensorDataset``, ``ComposeDataset`` (samples of
several datasets side by side), ``ChainDataset`` (iterable datasets one
after another), ``ConcatDataset`` (map-style datasets one after
another), ``Subset`` and ``random_split``."""
from __future__ import annotations

import bisect

import numpy as np
import torch


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Sample i is ``tuple(t[i] for t in tensors)``; the tensors (torch
    tensors or numpy arrays) share their first axis."""

    def __init__(self, tensors):
        if len({t.shape[0] for t in tensors}) != 1:
            raise ValueError("tensors must share their first axis")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Sample i is the fields of every dataset's sample i, in order (a
    tuple or list sample contributes its fields)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if len({len(d) for d in self.datasets}) != 1:
            raise ValueError("ComposeDataset needs datasets of one length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative = np.cumsum([len(d) for d in self.datasets]
                                    ).tolist()

    def __len__(self):
        return self.cumulative[-1] if self.cumulative else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(f"index {idx} out of range for {len(self)}")
        ds_idx = bisect.bisect_right(self.cumulative, idx)
        prev = self.cumulative[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``s of the given lengths (or fractions summing to
    1, the last taking the remainder) over one random permutation: from
    ``generator`` (a ``torch.Generator``) when given, else from numpy's
    global generator, as in the reference."""
    total = len(dataset)
    lengths = list(lengths)
    if all(isinstance(n, float) for n in lengths) and \
            abs(sum(lengths) - 1.0) < 1e-6:
        lengths = [int(n * total) for n in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    if sum(lengths) != total:
        raise ValueError(f"lengths {lengths} do not sum to the dataset's "
                         f"{total}")
    if generator is not None:
        perm = torch.randperm(total, generator=generator).tolist()
    else:
        perm = np.random.permutation(total).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out
