"""The port's learning-rate schedulers (``paddle_tpu_torch/optimizer/lr.py``)
against the JAX package's (``paddle_tpu/optimizer/lr.py``).

Both are pure Python on floats, so every case holds the two sequences
bit-equal (``==``, no tolerance): 100 steps of each of the 17 schedulers
(``LinearWarmup`` over a float and over a cosine schedule), a
``state_dict`` round trip in the middle of a run, and the scheduler's
state inside the optimizer's ``state_dict``. ``ReduceOnPlateau`` steps on
a metric sequence drawn from a seeded numpy generator.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.optimizer import lr as plr

CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=512, warmup_steps=20,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([10, 40, 70],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.03),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=30,
                                                   end_lr=1e-4, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=30, end_lr=1e-4, power=1.5, cycle=True),
    "LinearWarmup_float": lambda m: m.LinearWarmup(0.1, 25, 0.0, 0.1),
    "LinearWarmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(1e-4, 1000), 100 // 4, 0.0, 1e-4),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.3, gamma=0.95),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.3, [15, 35, 80],
                                                 gamma=0.3),
    "StepDecay": lambda m: m.StepDecay(0.3, step_size=7, gamma=0.7),
    "LambdaDecay": lambda m: m.LambdaDecay(0.2, lambda e: 0.97 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, T_max=40,
                                                             eta_min=1e-3),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=100),
    "OneCycleLR_linear3": lambda m: m.OneCycleLR(
        0.1, total_steps=100, anneal_strategy="linear", three_phase=True),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=12),
    "CyclicLR_exp": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=9,
                                         step_size_down=5,
                                         mode="exp_range", exp_gamma=0.98),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=11, T_mult=2, eta_min=1e-4),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.9 + 0.05 * math.sin(e)),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=60),
}


def _metrics(n=100):
    # a loss that falls, then plateaus with noise, then rises
    rng = np.random.default_rng(7)
    base = np.concatenate([np.linspace(3.0, 1.0, 30), np.full(40, 1.0),
                           np.linspace(1.0, 1.5, n - 70)])
    return (base + 0.01 * rng.standard_normal(n)).tolist()


def _run(sched, n=100, metrics=None):
    out = [sched()]
    for i in range(n):
        if metrics is None:
            sched.step()
        else:
            sched.step(metrics[i])
        out.append(sched())
    return out


def test_every_scheduler_is_covered():
    names = {n for n, v in vars(jlr).items()
             if isinstance(v, type) and issubclass(v, jlr.LRScheduler)
             and v is not jlr.LRScheduler and n != "CosineAnnealingLR"}
    covered = {n.split("_")[0] for n in CASES} | {"ReduceOnPlateau"}
    assert names == covered and len(names) == 17
    assert plr.CosineAnnealingLR is plr.CosineAnnealingDecay


@pytest.mark.parametrize("case", list(CASES))
def test_lr_sequence_bit_equal_to_jax(case):
    assert _run(CASES[case](plr)) == _run(CASES[case](jlr))


def test_reduce_on_plateau_bit_equal_to_jax():
    kw = dict(mode="min", factor=0.5, patience=4, cooldown=2, min_lr=1e-4)
    port = _run(plr.ReduceOnPlateau(0.1, **kw), metrics=_metrics())
    ref = _run(jlr.ReduceOnPlateau(0.1, **kw), metrics=_metrics())
    assert port == ref
    assert min(port) < 0.1   # the plateau cut the rate
    # a one-element tensor is a metric as well
    s = plr.ReduceOnPlateau(0.1, patience=0)
    s.step(torch.tensor(1.0))
    s.step(torch.tensor([2.0]))
    assert s() == pytest.approx(0.01)


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_round_trip(case):
    port, ref = CASES[case](plr), CASES[case](jlr)
    _run(port, 37)
    _run(ref, 37)
    state = port.state_dict()
    assert state == ref.state_dict()
    resumed = CASES[case](plr)
    resumed.set_state_dict(dict(state))
    assert _run(resumed, 20) == _run(port, 20) == _run(ref, 20)


def test_optimizer_carries_the_scheduler_state():
    p = torch.nn.Parameter(torch.zeros(3))
    sched = plr.StepDecay(0.4, step_size=3, gamma=0.5)
    opt = port_opt.SGD(learning_rate=sched, parameters=[p])
    for _ in range(7):
        sched.step()
    state = opt.state_dict()
    assert state["LR_Scheduler"]["last_epoch"] == 7
    sched2 = plr.StepDecay(0.4, step_size=3, gamma=0.5)
    opt2 = port_opt.SGD(learning_rate=sched2, parameters=[p])
    opt2.set_state_dict(state)
    assert opt2.get_lr() == opt.get_lr() == 0.1
    with pytest.raises(RuntimeError):
        opt2.set_lr(0.3)
