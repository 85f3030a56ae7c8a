"""The random state of the ``paddle.*`` surface (counterpart:
``paddle_tpu/framework/random.py``).

The port keeps its own explicit ``torch.Generator``s: one for the CPU
and one per card, made when first used and seeded with the last
``paddle.seed``. The random ops (``ops/random_ops.py``) draw from the
generator of the device they fill. JAX's counter-based PRNG is not
reproduced, so the same seed gives other numbers than the reference:
the ops are held by their distributions, and by "same seed, same
values" within the port. ``paddle.seed`` also seeds NumPy's global
state, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

_seed = 0
_generators: dict[str, torch.Generator] = {}


def generator(device) -> torch.Generator:
    """The port's generator for ``device`` (a ``torch.device``)."""
    key = "cpu" if device.type == "cpu" else f"cuda:{device.index or 0}"
    g = _generators.get(key)
    if g is None:
        g = torch.Generator(device=key)
        g.manual_seed(_seed)
        _generators[key] = g
    return g


def seed(s: int):
    """paddle.seed: reset every generator of the port to ``s``."""
    global _seed
    _seed = int(s) & 0xFFFFFFFFFFFFFFFF
    for g in _generators.values():
        g.manual_seed(_seed)
    np.random.seed(_seed & 0x7FFFFFFF)
    return _seed


def get_rng_state(device=None):
    """The CPU generator's state (a uint8 tensor), as a one-element list
    the way upstream returns one state per device of the place."""
    return [generator(torch.device("cpu")).get_state()]


def _state_tensor(state):
    """A generator state as ``set_state`` takes it (a uint8 tensor on the
    host), from a torch tensor, a paddle ``Tensor`` or a NumPy array: a
    state saved with ``paddle.save`` loads as a ``Tensor`` on the current
    place."""
    from ..ops.dispatch import unwrap
    return unwrap(state, device=torch.device("cpu")).to("cpu", torch.uint8)


def set_rng_state(state_list, device=None):
    states = state_list if isinstance(state_list, (list, tuple)) \
        else [state_list]
    generator(torch.device("cpu")).set_state(_state_tensor(states[0]))


def get_cuda_rng_state():
    """One state per card (empty without a card)."""
    return [generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list):
    if not isinstance(state_list, (list, tuple)):
        raise TypeError("set_cuda_rng_state expects a list of states")
    if len(state_list) > torch.cuda.device_count():
        raise ValueError(
            f"{len(state_list)} states for "
            f"{torch.cuda.device_count()} cards")
    for i, st in enumerate(state_list):
        generator(torch.device("cuda", i)).set_state(_state_tensor(st))
