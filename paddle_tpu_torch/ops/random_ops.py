"""Random ops (counterpart: ``paddle_tpu/ops/random_ops.py``).

Each draws from the port's generator of the device it fills
(``framework/random.py``), so ``paddle.seed(s)`` makes a run repeat
itself. The numbers differ from the reference's JAX PRNG: these ops are
held by their distributions. A nonzero ``seed`` argument draws from a
generator of its own seeded with it, as the reference keys its draw.
The in-place forms (``uniform_``, ``normal_``, ``exponential_``,
``bernoulli_``) replace the payload, as the reference does.
"""
from __future__ import annotations

import torch

from ..framework import dtype as dtype_mod
from ..framework.place import current_device
from ..framework.random import generator
from ..tensor import Tensor
from .common import default_float, ensure_tensor, int_list, raw


def _dt(dtype):
    return dtype_mod.to_torch_dtype(dtype) if dtype is not None \
        else default_float()


def _gen(device, seed=0):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return generator(device)


def _draw(fill, shape, dtype, device, seed=0):
    """A new tensor of ``shape`` filled by ``fill(tensor, generator)`` in
    fp32 (or the dtype itself where it is wider) and cast to ``dtype``."""
    work = dtype if dtype in (torch.float32, torch.float64) \
        else torch.float32
    v = torch.empty(shape, dtype=work, device=device)
    fill(v, _gen(device, seed))
    return v.to(dtype)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_device()
    return Tensor._wrap(_draw(
        lambda v, g: v.uniform_(float(min), float(max), generator=g),
        tuple(int_list(shape)), _dt(dtype), dev, seed))


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def randn(shape, dtype=None, name=None):
    dev = current_device()
    return Tensor._wrap(_draw(lambda v, g: v.normal_(generator=g),
                              tuple(int_list(shape)), _dt(dtype), dev))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = current_device()
    return Tensor._wrap(_draw(
        lambda v, g: v.normal_(float(mean), float(std), generator=g),
        tuple(int_list(shape)), _dt(dtype), dev, seed))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, (Tensor, torch.Tensor)) or \
            isinstance(std, (Tensor, torch.Tensor)):
        m = raw(ensure_tensor(mean))
        s = raw(ensure_tensor(std, ref=m))
        shp = torch.broadcast_shapes(m.shape, s.shape)
        dt = m.dtype if m.is_floating_point() else default_float()
        z = _draw(lambda v, g: v.normal_(generator=g), shp, dt, m.device)
        return Tensor._wrap(z * s + m)
    return gaussian(shape or [1], float(mean), float(std))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    v = torch.randint(int(low), int(high), tuple(int_list(shape)),
                      generator=generator(dev), device=dev,
                      dtype=dtype_mod.to_torch_dtype(dtype or "int64"))
    return Tensor._wrap(v)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    v = raw(ensure_tensor(x))
    if high is None:
        low, high = 0, low
    out = torch.randint(int(low), int(high), v.shape,
                        generator=generator(v.device), device=v.device,
                        dtype=v.dtype if dtype is None
                        else dtype_mod.to_torch_dtype(dtype))
    return Tensor._wrap(out)


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    v = torch.randperm(int(n), generator=generator(dev), device=dev)
    return Tensor._wrap(v.to(dtype_mod.to_torch_dtype(dtype)))


def bernoulli(x, name=None):
    v = raw(ensure_tensor(x))
    p = v if v.is_floating_point() else v.to(default_float())
    return Tensor._wrap(torch.bernoulli(p.detach(),
                                        generator=generator(v.device))
                        .to(p.dtype))


def poisson(x, name=None):
    v = raw(ensure_tensor(x))
    return Tensor._wrap(torch.poisson(v.detach(),
                                      generator=generator(v.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    v = raw(ensure_tensor(x))
    out = torch.multinomial(v.detach(), int(num_samples),
                            replacement=bool(replacement),
                            generator=generator(v.device))
    return Tensor._wrap(out)


def log_normal(mean=1.0, std=2.0, shape=None, dtype=None, name=None):
    """exp of normal(mean, std) samples."""
    out = gaussian(list(shape) if shape is not None else [1], float(mean),
                   float(std), dtype=dtype)
    return Tensor._wrap(torch.exp(raw(out)))


def randn_like(x, dtype=None, name=None):
    v = raw(ensure_tensor(x))
    td = default_float() if dtype is None else _dt(dtype)
    return Tensor._wrap(_draw(lambda t, g: t.normal_(generator=g), v.shape,
                              td, v.device))


def rand_like(x, dtype=None, name=None):
    v = raw(ensure_tensor(x))
    td = default_float() if dtype is None else _dt(dtype)
    return Tensor._wrap(_draw(lambda t, g: t.uniform_(0.0, 1.0, generator=g),
                              v.shape, td, v.device))


def _refill(x, fill, seed=0):
    v = raw(x)
    x._replace(_draw(fill, v.shape, v.dtype, v.device, seed))
    return x


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    return _refill(x, lambda v, g: v.uniform_(float(min), float(max),
                                              generator=g), seed)


def normal_(x, mean=0.0, std=1.0, name=None):
    return _refill(x, lambda v, g: v.normal_(float(mean), float(std),
                                             generator=g))


def exponential_(x, lam=1.0, name=None):
    return _refill(x, lambda v, g: v.exponential_(float(lam), generator=g))


def bernoulli_(x, p=0.5, name=None):
    return _refill(x, lambda v, g: v.bernoulli_(float(p), generator=g))
