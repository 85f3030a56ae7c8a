"""Datasets and worker hooks for the port's DataLoader worker tests. They
live at module level in a module that imports only the port, so a spawned
worker can unpickle them without importing JAX."""
import os
import time

import numpy as np
import torch

from paddle_tpu_torch.io import Dataset, get_worker_info

_INIT = {}


class RangeDataset(Dataset):
    """Sample i: a float32 row of four i's and the label i % 3."""

    def __init__(self, n=64):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((4,), i, "float32"), np.int64(i % 3)


def record_init(wid):
    """A ``worker_init_fn``: notes the id it was given and whether CUDA
    was initialized in the worker when it ran."""
    _INIT["wid"] = wid
    _INIT["cuda"] = torch.cuda.is_initialized()


class WorkerInfoDataset(Dataset):
    """Sample i: (i, the serving worker's id, its number of workers, the
    id ``record_init`` saw, whether CUDA was initialized then and now,
    the process id)."""

    def __len__(self):
        return 32

    def __getitem__(self, i):
        info = get_worker_info()
        return np.asarray([i, info.id, info.num_workers,
                           _INIT.get("wid", -1), int(_INIT.get("cuda", 1)),
                           int(torch.cuda.is_initialized()), os.getpid()],
                          np.int64)


class FailingDataset(RangeDataset):
    """Raises on sample 13."""

    def __getitem__(self, i):
        if i == 13:
            raise ValueError("sample 13 is broken")
        return super().__getitem__(i)


class SlowDataset(RangeDataset):
    """Takes 30 s for every sample."""

    def __getitem__(self, i):
        time.sleep(30)
        return super().__getitem__(i)


class DyingDataset(RangeDataset):
    """Ends its worker process on sample 9."""

    def __getitem__(self, i):
        if i == 9:
            os._exit(3)
        return super().__getitem__(i)
