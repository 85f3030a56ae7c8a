"""The op sweep's inputs and its device run.

Every entry of the op table (``op_table.py``) is run by its ``call`` on
inputs drawn from its domain with NumPy's ``default_rng`` seeded by the
crc32 of its name: float32 inputs for the outputs, float64 for the
gradients of ``sum(out)`` where the entry has ``grad``. The CPU tests
hold the port to the reference this way; ``device_sweep`` holds the
port on a card to its own CPU result at the entry's tolerance, and
``random_checks`` holds the random ops by their moments and by seeded
reruns (the same seed gives the same values).
"""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from .registry import registered_ops, tolerances_for

# the sweep's families, by where their rows start in the op table
FAMILY_STARTS = [("elementwise", "abs"), ("declared", "relu"),
                 ("creation_manipulation", "arange"),
                 ("indexing_reductions_linalg", "gather_nd")]


def family(name):
    from .op_table import TABLE
    order = [n for n, _ in TABLE]
    pos, fam = order.index(name), None
    for f, first in FAMILY_STARTS:
        if pos >= order.index(first):
            fam = f
    return fam


def gen_array(domain, shape, rng):
    n = int(np.prod(shape))
    if domain == "real":
        return rng.uniform(-2.0, 2.0, shape)
    if domain == "nonzero":
        return rng.choice([-1.0, 1.0], shape) * rng.uniform(0.5, 2.0, shape)
    if domain == "positive":
        return rng.uniform(0.3, 3.0, shape)
    if domain == "unit":
        return rng.uniform(-0.9, 0.9, shape)
    if domain == "gt1":
        return rng.uniform(1.1, 3.0, shape)
    if domain == "prob":
        return rng.uniform(0.05, 0.95, shape)
    if domain == "int":
        return rng.integers(1, 16, shape)
    if domain == "intsmall":
        return rng.integers(0, 5, shape)
    if domain == "bool":
        return rng.random(shape) > 0.5
    if domain == "distinct":
        # well-separated values, shuffled: no ties for sort/topk
        vals = np.arange(n, dtype=np.float64) * 0.37 - 0.15 * n
        rng.shuffle(vals)
        return vals.reshape(shape)
    raise ValueError(f"unknown domain {domain}")


def seed_of(name):
    return zlib.crc32(name.encode())


def inputs(spec, seed, float_dtype):
    """The entry's numpy inputs, floats as ``float_dtype``."""
    rng = np.random.default_rng(seed)
    shapes = spec.shapes if len(spec.shapes) == spec.n_in \
        else spec.shapes * spec.n_in
    domains = [spec.domain, spec.domain2 or spec.domain][:spec.n_in]
    out = []
    for d, s in zip(domains, shapes):
        a = gen_array(d, tuple(s), rng)
        if a.dtype == np.float64:
            a = a.astype(float_dtype)
        out.append(a)
    return out


def call_of(paddle, F, spec):
    """The entry's ``call`` over the ``paddle`` and ``F`` namespaces given
    (its generated function when it has none)."""
    if spec.call is not None:
        args = "x" if spec.n_in == 1 else "x, y"
        return eval(f"lambda {args}: {spec.call}",
                    {"paddle": paddle, "F": F, "np": np})
    return getattr(paddle, spec.name)


def flatten(out):
    if isinstance(out, (list, tuple)):
        return [o for item in out for o in flatten(item)]
    return [out]


def _numpy(t):
    return np.asarray(t.numpy())


def _run(place, spec, arrays, grad):
    """(outputs, input gradients) of the entry on ``place``, as numpy."""
    import paddle_tpu_torch as paddle
    from ..framework import place as place_mod
    from ..nn import functional as F
    prev = place_mod._current_place
    place_mod.set_device(place)
    try:
        ts = [paddle.to_tensor(a, stop_gradient=not (
            grad and np.issubdtype(a.dtype, np.floating))) for a in arrays]
        out = call_of(paddle, F, spec)(*ts)
        outs = [_numpy(o) for o in flatten(out)]
        grads = []
        if grad:
            first = flatten(out)[0]
            paddle.sum(first).backward()
            grads = [np.zeros_like(a) if t.grad is None else _numpy(t.grad)
                     for a, t in zip(arrays, ts)
                     if np.issubdtype(a.dtype, np.floating)]
        return outs, grads
    finally:
        place_mod._current_place = prev


def _worst(got, want, atol, rtol):
    """The largest |got - want| / (atol + rtol |want|): 1 is the bound."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return math.inf
    if got.dtype == np.bool_ or np.issubdtype(got.dtype, np.integer):
        return 0.0 if np.array_equal(got, want) else math.inf
    g, w = got.astype(np.complex128 if np.iscomplexobj(got)
                      else np.float64), want.astype(np.float64
                                                     if not np.iscomplexobj(
                                                         want)
                                                     else np.complex128)
    if not g.size:
        return 0.0
    return float(np.max(np.abs(g - w) / (atol + rtol * np.abs(w))))


def device_sweep(device="gpu"):
    """Every op of the table on ``device`` against the port's CPU result,
    outputs and, for ``grad`` entries, gradients, at the entry's
    tolerance. Returns {family: {"ops": n, "worst": ratio, "worst_op":
    name}} (a ratio of 1 is the bound) and the failures."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report, failures = {}, []
    for name, spec in sorted(registered_ops().items()):
        atol, rtol = tolerances_for(spec)
        worst = 0.0
        for grad in ((False, True) if spec.grad in (True, "zero")
                     else (False,)):
            arrays = inputs(spec, seed_of(name) + int(grad),
                            np.float64 if grad else np.float32)
            cpu_out, cpu_grads = _run("cpu", spec, arrays, grad)
            dev_out, dev_grads = _run(device, spec, arrays, grad)
            pairs = list(zip(dev_grads, cpu_grads)) if grad \
                else list(zip(dev_out, cpu_out))
            if len(dev_out) != len(cpu_out):
                worst = math.inf
            for g, w in pairs:
                worst = max(worst, _worst(g, w, atol, rtol))
        fam = report.setdefault(family(name), {"ops": 0, "worst": 0.0,
                                               "worst_op": None})
        fam["ops"] += 1
        if worst >= fam["worst"]:
            fam["worst"], fam["worst_op"] = worst, name
        if not worst <= 1.0:
            failures.append((name, worst))
    return report, failures


# the random ops: (name, draw(paddle) -> Tensor, mean, variance) of one
# sample's distribution
N_RANDOM = 1 << 20


def _random_cases(paddle):
    n = N_RANDOM
    x4 = paddle.full([n], 4.0)
    p3 = paddle.full([n], 0.3)
    return [
        ("rand", lambda: paddle.rand([n]), 0.5, 1 / 12),
        ("uniform", lambda: paddle.uniform([n], min=-2.0, max=4.0),
         1.0, 3.0),
        ("randn", lambda: paddle.randn([n]), 0.0, 1.0),
        ("standard_normal", lambda: paddle.standard_normal([n]), 0.0, 1.0),
        ("gaussian", lambda: paddle.gaussian([n], mean=1.0, std=2.0),
         1.0, 4.0),
        ("normal", lambda: paddle.normal(1.0, 0.5, [n]), 1.0, 0.25),
        ("normal_tensors", lambda: paddle.normal(x4, p3), 4.0, 0.09),
        ("log_normal", lambda: paddle.log_normal(0.0, 0.5, [n]),
         math.exp(0.125), (math.exp(0.25) - 1) * math.exp(0.25)),
        ("randint", lambda: paddle.randint(0, 10, [n]), 4.5, 99 / 12),
        ("randint_like", lambda: paddle.randint_like(x4, 0, 10),
         4.5, 99 / 12),
        ("randperm", lambda: paddle.randperm(n), (n - 1) / 2,
         (n * n - 1) / 12),
        ("bernoulli", lambda: paddle.bernoulli(p3), 0.3, 0.21),
        ("poisson", lambda: paddle.poisson(x4), 4.0, 4.0),
        ("multinomial", lambda: paddle.multinomial(
            paddle.to_tensor([0.1, 0.2, 0.7]), n, replacement=True),
         1.6, 0.44),
        ("rand_like", lambda: paddle.rand_like(x4), 0.5, 1 / 12),
        ("randn_like", lambda: paddle.randn_like(x4), 0.0, 1.0),
        ("uniform_", lambda: paddle.zeros([n]).uniform_(0.0, 2.0),
         1.0, 1 / 3),
        ("normal_", lambda: paddle.zeros([n]).normal_(3.0, 2.0), 3.0, 4.0),
        ("exponential_", lambda: paddle.zeros([n]).exponential_(2.0),
         0.5, 0.25),
        ("bernoulli_", lambda: paddle.zeros([n]).bernoulli_(0.6),
         0.6, 0.24),
    ]


def random_checks(device):
    """Each random op on ``device``: its sample mean within 6 standard
    errors of the distribution's mean, its sample variance within 3%
    (plus 6 standard errors of a normal's) of the distribution's, a
    rerun after the same ``paddle.seed`` bit-equal, and a run after
    another seed different. Returns {name: {"mean_z", "var_rel"}} and the
    failures."""
    import paddle_tpu_torch as paddle
    from ..framework import place as place_mod
    prev = place_mod._current_place
    place_mod.set_device(device)
    report, failures = {}, []
    try:
        for name, draw, mean, var in _random_cases(paddle):
            paddle.seed(11)
            a = draw()
            paddle.seed(11)
            b = draw()
            paddle.seed(12)
            c = draw()
            v = a._value.double()
            z = abs(float(v.mean()) - mean) / math.sqrt(var / v.numel())
            rel = abs(float(v.var()) - var) / var
            same = torch.equal(a._value, b._value)
            differs = not torch.equal(a._value, c._value)
            report[name] = {"mean_z": z, "var_rel": rel}
            if not (z < 6 and rel < 0.03 + 6 * math.sqrt(2 / v.numel())
                    and same and differs):
                failures.append((name, z, rel, same, differs))
    finally:
        place_mod._current_place = prev
    return report, failures
