"""Datasets (counterpart: ``paddle_tpu/io/dataset.py``)."""
from __future__ import annotations


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


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
