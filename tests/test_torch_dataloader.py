"""The port's ``DataLoader`` workers, datasets and samplers
(``paddle_tpu_torch/io``) against the JAX package's.

- The three cases of ``tests/test_dataloader_mp.py`` on the port: spawned
  worker processes and worker threads deliver the batches in the
  sampler's order, and a ``collate_fn`` that cannot be pickled falls back
  to threads. Batches equal the single-process loader's, bit for bit.
- ``worker_init_fn`` runs once in each worker with its id,
  ``get_worker_info()`` answers there, and a worker never initializes
  CUDA; a worker's error comes back in the reference's words; a stalled
  worker is cut by the loader's ``timeout`` and a dead one is reported.
- The datasets and samplers are held to the reference by structure:
  lengths, items, disjointness and coverage of splits, the weights'
  frequencies (with a ``torch.Generator`` the port's draws are not the
  reference's; without one both draw from numpy's global generator).
- ``Model.fit`` with two workers gives LeNet the same losses and weights,
  bit for bit, as with none.

Every worker test gives the loader a ``timeout`` of 60 s or less, so no
read of a worker's result waits longer.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from _torch_dl_helpers import (DyingDataset, FailingDataset, RangeDataset,
                               SlowDataset, WorkerInfoDataset, record_init)
from paddle_tpu_torch import io as pio

TIMEOUT = 60


@pytest.mark.parametrize("shared", [True, False],
                         ids=["processes", "threads"])
def test_workers_deliver_batches_in_order(shared):
    dl = pio.DataLoader(RangeDataset(64), batch_size=8, num_workers=2,
                        shuffle=False, use_shared_memory=shared,
                        timeout=TIMEOUT)
    batches = list(dl)
    assert len(batches) == 8
    plain = list(pio.DataLoader(RangeDataset(64), batch_size=8))
    for i, ((x, y), (px, py)) in enumerate(zip(batches, plain)):
        assert x[0][0].item() == i * 8   # order kept across workers
        assert list(x.shape) == [8, 4] and x.dtype == torch.float32
        assert torch.equal(x, px) and torch.equal(y, py)


def test_reference_multiprocess_case_on_the_port():
    dl = pio.DataLoader(RangeDataset(64), batch_size=8, num_workers=2,
                        shuffle=False, timeout=TIMEOUT)
    batches = list(dl)
    assert len(batches) == 8
    for i, (x, y) in enumerate(batches):
        assert x.numpy()[0][0] == i * 8
        assert list(x.shape) == [8, 4]


def test_reference_thread_case_on_the_port():
    dl = pio.DataLoader(RangeDataset(64), batch_size=8, num_workers=2,
                        shuffle=False, use_shared_memory=False,
                        timeout=TIMEOUT)
    batches = list(dl)
    assert len(batches) == 8
    assert batches[5][0].numpy()[0][0] == 40


def test_unpicklable_collate_falls_back_to_threads():
    dl = pio.DataLoader(RangeDataset(32), batch_size=8, num_workers=2,
                        collate_fn=lambda b: pio.default_collate_fn(b),
                        timeout=TIMEOUT)
    batches = list(dl)
    assert len(batches) == 4
    assert dl.worker_start_s == 0.0   # no process was started
    assert [int(x[0][0]) for x, _ in batches] == [0, 8, 16, 24]


@pytest.mark.parametrize("shared", [True, False],
                         ids=["processes", "threads"])
def test_worker_init_fn_and_get_worker_info(shared):
    dl = pio.DataLoader(WorkerInfoDataset(), batch_size=4, num_workers=2,
                        use_shared_memory=shared, worker_init_fn=record_init,
                        timeout=TIMEOUT)
    rows = torch.cat(list(dl)).numpy()
    assert rows[:, 0].tolist() == list(range(32))
    assert set(rows[:, 1]) <= {0, 1} and set(rows[:, 2]) == {2}
    if shared:
        # each process ran its init with its own id, and no worker
        # initialized CUDA, neither before its init nor after its samples
        assert (rows[:, 3] == rows[:, 1]).all()
        assert (rows[:, 4] == 0).all() and (rows[:, 5] == 0).all()
        # samples come from worker processes, one process to an id
        assert os.getpid() not in set(rows[:, 6])
        assert len({(w, pid) for w, pid in rows[:, [1, 6]].tolist()}) == \
            len(set(rows[:, 1]))
    assert pio.get_worker_info() is None   # none outside a worker


def test_worker_error_is_raised_in_the_reference_words():
    dl = pio.DataLoader(FailingDataset(32), batch_size=8, num_workers=2,
                        timeout=TIMEOUT)
    with pytest.raises(RuntimeError,
                       match=r"DataLoader worker \d failed on batch 1: "
                             r"ValueError\('sample 13 is broken'\)"):
        list(dl)
    threads = pio.DataLoader(FailingDataset(32), batch_size=8,
                             num_workers=2, use_shared_memory=False,
                             timeout=TIMEOUT)
    with pytest.raises(ValueError, match="sample 13 is broken"):
        list(threads)


@pytest.mark.parametrize("shared", [True, False],
                         ids=["processes", "threads"])
def test_a_stalled_worker_is_cut_by_the_timeout(shared):
    dl = pio.DataLoader(SlowDataset(8), batch_size=4, num_workers=2,
                        use_shared_memory=shared, timeout=3)
    with pytest.raises(RuntimeError, match="timed out"):
        list(dl)


def test_a_dead_worker_is_reported():
    dl = pio.DataLoader(DyingDataset(16), batch_size=4, num_workers=2,
                        timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        list(dl)


def test_iterable_dataset_batches_as_the_reference():
    class Stream(pio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(10, dtype=np.float32))

    class JStream(jio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(10, dtype=np.float32))

    got = [b.tolist() for b in pio.DataLoader(Stream(), batch_size=4)]
    want = [np.asarray(b.numpy()).tolist()
            for b in jio.DataLoader(JStream(), batch_size=4)]
    assert got == want == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    dropped = pio.DataLoader(Stream(), batch_size=4, drop_last=True)
    assert len(list(dropped)) == 2
    with pytest.raises(TypeError):
        len(pio.DataLoader(Stream(), batch_size=4))


def _items(ds):
    return [tuple(np.asarray(f).tolist() for f in
                  (s if isinstance(s, tuple) else (s,)))
            for s in (ds[i] for i in range(len(ds)))]


def test_compose_concat_subset_equal_the_reference():
    a, b = RangeDataset(6), RangeDataset(6)
    arr = np.arange(6, dtype=np.float32)
    assert _items(pio.ComposeDataset([a, pio.TensorDataset([arr])])) == \
        _items(jio.ComposeDataset([a, jio.TensorDataset([arr])]))
    cat, jcat = pio.ConcatDataset([a, RangeDataset(3)]), \
        jio.ConcatDataset([a, RangeDataset(3)])
    assert len(cat) == len(jcat) == 9
    assert _items(cat) == _items(jcat)
    assert _items([cat[-1]]) == _items([jcat[-1]])
    with pytest.raises(IndexError):
        cat[9]
    sub = pio.Subset(b, [5, 1, 3])
    assert _items(sub) == _items(jio.Subset(b, [5, 1, 3]))
    with pytest.raises(ValueError):
        pio.ComposeDataset([RangeDataset(2), RangeDataset(3)])


def test_chain_dataset_equals_the_reference():
    class Part(pio.IterableDataset):
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def __iter__(self):
            return iter(range(self.lo, self.hi))

    chain = pio.ChainDataset([Part(0, 3), Part(3, 5)])
    jchain = jio.ChainDataset([Part(0, 3), Part(3, 5)])
    # iterated, not list()ed: list() asks for a len(), which both refuse
    assert [v for v in chain] == [v for v in jchain] == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("lengths", [[7, 3], [0.5, 0.3, 0.2]],
                         ids=["counts", "fractions"])
def test_random_split_partitions_as_the_reference(lengths):
    ds = RangeDataset(10)
    np.random.seed(3)
    got = pio.random_split(ds, lengths)
    np.random.seed(3)
    want = jio.random_split(ds, lengths)
    assert [len(s) for s in got] == [len(s) for s in want]
    flat = [i for s in got for i in s.indices]
    assert sorted(flat) == list(range(10))   # disjoint, covering
    # without a generator both draw numpy's permutation
    assert [s.indices for s in got] == [s.indices for s in want]
    g = [pio.random_split(ds, lengths, generator=torch.Generator()
                          .manual_seed(5)) for _ in range(2)]
    assert [s.indices for s in g[0]] == [s.indices for s in g[1]]
    assert sorted(i for s in g[0] for i in s.indices) == list(range(10))
    with pytest.raises(ValueError):
        pio.random_split(ds, [4, 4])


def test_subset_random_sampler_permutes_its_indices():
    idx = [3, 9, 4, 12, 7]
    for sampler in (pio.SubsetRandomSampler(idx),
                    pio.SubsetRandomSampler(
                        idx, generator=torch.Generator().manual_seed(0)),
                    jio.SubsetRandomSampler(idx)):
        order = list(sampler)
        assert sorted(order) == sorted(idx) and len(sampler) == 5


def test_weighted_random_sampler_follows_the_weights():
    weights = [1.0, 2.0, 0.0, 5.0]
    n = 40000
    draws = np.asarray(list(pio.WeightedRandomSampler(weights, n)))
    jdraws = np.asarray(list(jio.WeightedRandomSampler(weights, n)))
    p = np.asarray(weights) / sum(weights)
    for d in (draws, jdraws):
        freq = np.bincount(d, minlength=4) / n
        # 5 standard deviations of a binomial share at n draws
        np.testing.assert_allclose(freq, p, atol=5 * np.sqrt(0.25 / n))
        assert (d != 2).all()   # weight 0 is never drawn
    once = list(pio.WeightedRandomSampler([1, 1, 1, 1, 1], 5,
                                          replacement=False))
    assert sorted(once) == [0, 1, 2, 3, 4]


def test_fit_with_workers_equals_fit_without():
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.vision import models
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (32, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, (32,)).astype(np.int64)

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    runs = []
    for workers in (0, 2):
        net = models.LeNet(device="cpu", seed=3)
        model = Model(net).prepare(
            popt.Adam(learning_rate=1e-3, parameters=net.parameters()),
            pnn.CrossEntropyLoss())
        rec = Losses()
        loader = pio.DataLoader(pio.TensorDataset([x, y]), batch_size=8,
                                num_workers=workers, timeout=TIMEOUT)
        model.fit(loader, epochs=2, verbose=0, callbacks=[rec])
        runs.append((rec.losses, [p.detach().clone()
                                  for p in net.parameters()]))
    assert len(runs[0][0]) == 8 and runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
