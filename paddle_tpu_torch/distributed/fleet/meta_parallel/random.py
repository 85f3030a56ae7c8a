"""The RNG state tracker (counterpart: ``paddle_tpu/distributed/fleet/
meta_parallel/random.py``; upstream ``parallel_layers/random.py``).

Named states over the port's explicit ``torch.Generator``s
(``framework/random.py``): ``rng_state(name)`` swaps the tracked state
into the port's generators and PyTorch's default ones (the random ops and
dropout draw from them), and swaps it back out, advanced, on exit.
``model_parallel_random_seed(seed)`` adds the three upstream states:
``global_seed`` and ``model_parallel_rng`` the same on every mp rank
(dropout on replicated activations must agree), ``local_seed`` different
on each mp rank (dropout on a rank's own shard must not). The bits are
PyTorch's, not JAX's: the tests hold these properties, not the
reference's numbers.
"""
from __future__ import annotations

import contextlib

import torch

from ....framework import random as _random


def _devices():
    out = [torch.device("cpu")]
    out += [torch.device("cuda", i) for i in range(torch.cuda.device_count())
            if torch.cuda.is_initialized()]
    return out


def _get_states():
    states = {str(d): _random.generator(d).get_state() for d in _devices()}
    states["torch"] = torch.get_rng_state()
    if torch.cuda.is_initialized():
        states["torch_cuda"] = torch.cuda.get_rng_state_all()
    return states


def _set_states(states):
    for d in _devices():
        if str(d) in states:
            _random.generator(d).set_state(states[str(d)])
    torch.set_rng_state(states["torch"])
    if "torch_cuda" in states and torch.cuda.is_initialized():
        torch.cuda.set_rng_state_all(states["torch_cuda"])


def _seeded_states(seed):
    saved = _get_states()
    for d in _devices():
        _random.generator(d).manual_seed(seed)
    torch.manual_seed(seed)
    states = _get_states()
    _set_states(saved)
    return states


class RNGStatesTracker:
    def __init__(self):
        self._states = {}
        self._seeds = set()

    def reset(self):
        self._states = {}
        self._seeds = set()

    def add(self, name, seed):
        if seed in self._seeds:
            raise ValueError(f"seed {seed} already exists")
        if name in self._states:
            raise ValueError(f"rng state {name} already added")
        self._seeds.add(seed)
        self._states[name] = _seeded_states(int(seed))

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng"):
        if name not in self._states:
            raise ValueError(f"rng state {name} does not exist")
        outer = _get_states()
        _set_states(self._states[name])
        try:
            yield
        finally:
            self._states[name] = _get_states()
            _set_states(outer)


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None):
    """Seed the tracker's states from ``seed`` (default 2048) and this
    rank's mp index, and the port's generators with the global seed."""
    from ...sharding_api import get_default_mesh
    mp_rank = get_default_mesh().coord["mp"]
    base = seed if seed is not None else 2048
    global_seed = base
    local_seed = base * 1024 + mp_rank * 100 + 1
    _tracker.reset()
    _tracker.add("global_seed", global_seed)
    _tracker.add("model_parallel_rng", global_seed + 1)
    _tracker.add("local_seed", local_seed)
    _random.seed(global_seed)
    torch.manual_seed(global_seed)
