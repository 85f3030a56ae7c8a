"""The port's optimizers and gradient clipping
(``paddle_tpu_torch/optimizer``, ``paddle_tpu_torch/nn/clip.py``) against
the JAX package's on the same seeded numpy parameters and gradients.

SGD, Momentum (heavy ball and Nesterov), Adam and AdamW (with and
without weight decay, as a float or an ``L2Decay``) after one step and
after five: parameters agree at rtol 1e-6 in fp32 (atol 1e-9 for
entries that pass through zero), since the port keeps the reference's
arithmetic and order of operations and only the last bit of a rounding
may differ. Also: AdamW's decay exclusion by parameter name, fp32 master
weights under ``multi_precision``, the ``state_dict`` round trip, the
learning-rate rules, and the three clip classes with the train step's
functional clip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train_step import _functional_clip as jax_functional_clip
from paddle_tpu.tensor import Parameter, Tensor
from paddle_tpu_torch.jit.train_step import _functional_clip
from paddle_tpu_torch.nn import clip as port_clip
from paddle_tpu_torch import optimizer as port_opt

RTOL, ATOL = 1e-6, 1e-9
SHAPES = [(4, 5), (5,), (3, 3)]


def _arrays(seed, steps):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return params, grads


def _jax_run(cls, kw, params, grads, names=None):
    ps = [Parameter(jnp.asarray(p), name=n)
          for p, n in zip(params, names or [None] * len(params))]
    opt = getattr(paddle.optimizer, cls)(parameters=ps, **kw)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = Tensor(jnp.asarray(g))
        opt.step()
    return [np.asarray(p._value) for p in ps], opt


def _port_run(cls, kw, params, grads, names=None, dtype=torch.float32):
    ps = [torch.nn.Parameter(torch.from_numpy(p).to(dtype)) for p in params]
    entries = list(zip(names, ps)) if names else ps
    opt = getattr(port_opt, cls)(parameters=entries, **kw)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).to(dtype)
        opt.step()
    return ps, opt


OPTIMIZERS = {
    "sgd": ("SGD", {"learning_rate": 0.1}),
    "sgd_l2": ("SGD", {"learning_rate": 0.1, "weight_decay": 0.01}),
    "momentum": ("Momentum", {"learning_rate": 0.1, "momentum": 0.9}),
    "momentum_nesterov": ("Momentum", {"learning_rate": 0.1, "momentum": 0.8,
                                       "use_nesterov": True}),
    "momentum_l2": ("Momentum", {"learning_rate": 0.1, "weight_decay": 0.01}),
    "adam": ("Adam", {"learning_rate": 1e-2}),
    "adam_l2": ("Adam", {"learning_rate": 1e-2, "weight_decay": 0.01}),
    "adamw": ("AdamW", {"learning_rate": 1e-2}),
    "adamw_decay": ("AdamW", {"learning_rate": 1e-2, "weight_decay": 0.3,
                              "beta1": 0.8, "beta2": 0.99}),
}


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("which", list(OPTIMIZERS))
def test_updates_match_jax(which, steps):
    cls, kw = OPTIMIZERS[which]
    params, grads = _arrays(seed=steps, steps=steps)
    want, jopt = _jax_run(cls, kw, params, grads)
    got, opt = _port_run(cls, kw, params, grads)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL)
    assert opt._step_count == jopt._step_count == steps


def test_adamw_decay_exclusion_by_name():
    # mirrors the JAX package's test: lr 0, excluded from decay ->
    # unchanged; the decayed one moves by p * (1 - lr * coeff) as in JAX
    params, grads = _arrays(seed=7, steps=2)
    names = ["skipme.w", "linear.b", "linear.w"]
    fun = lambda n: "skipme" not in n  # noqa: E731
    got, _ = _port_run("AdamW", {"learning_rate": 0.0, "weight_decay": 0.5,
                                 "apply_decay_param_fun": fun},
                       params, grads, names)
    np.testing.assert_array_equal(got[0].detach().numpy(), params[0])
    kw = {"learning_rate": 1e-2, "weight_decay": 0.5,
          "apply_decay_param_fun": fun}
    want, _ = _jax_run("AdamW", kw, params, grads, names)
    got, _ = _port_run("AdamW", kw, params, grads, names)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL)
    # unnamed parameters give the function "" (getattr(p, "name") is None)
    seen = []
    _port_run("AdamW", {"apply_decay_param_fun": seen.append}, params,
              grads[:1])
    assert seen == ["", "", ""]


@pytest.mark.parametrize("cls", ["Momentum", "SGD", "Adam"])
def test_l2decay_weight_decay_matches_jax(cls):
    # a regularizer object as weight_decay: its coefficient is applied as
    # the float would be, in both packages
    from paddle_tpu.regularizer import L2Decay as JaxL2Decay
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay
    params, grads = _arrays(seed=6, steps=3)
    kw = {"learning_rate": 0.1}
    want, _ = _jax_run(cls, dict(kw, weight_decay=JaxL2Decay(0.05)), params,
                       grads)
    # each run on its own copy: the port's parameters share the arrays'
    # memory and are updated in place
    got, opt = _port_run(cls, dict(kw, weight_decay=L2Decay(0.05)),
                         [p.copy() for p in params], grads)
    assert opt._weight_decay == 0.05
    as_float, _ = _port_run(cls, dict(kw, weight_decay=0.05),
                            [p.copy() for p in params], grads)
    as_l1, _ = _port_run(cls, dict(kw, weight_decay=L1Decay(0.05)),
                         [p.copy() for p in params], grads)
    for g, w, f, l1 in zip(got, want, as_float, as_l1):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL)
        assert torch.equal(g, f) and torch.equal(g, l1)


def test_momentum_multi_precision_keeps_fp32_velocity():
    params, grads = _arrays(seed=8, steps=3)
    kw = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}
    jps = [Parameter(jnp.asarray(p).astype(jnp.bfloat16)) for p in params]
    jopt = paddle.optimizer.Momentum(parameters=jps, **kw)
    for gs in grads:
        for p, g in zip(jps, gs):
            p.grad = Tensor(jnp.asarray(g).astype(jnp.bfloat16))
        jopt.step()
    got, opt = _port_run("Momentum", kw, params, grads,
                         dtype=torch.bfloat16)
    for p, jp in zip(got, jps):
        accs, jaccs = opt._get_accumulators(p), jopt._get_accumulators(jp)
        assert p.dtype == torch.bfloat16
        assert accs["velocity"].dtype == accs["master_weight"].dtype == \
            torch.float32
        for name in ("velocity", "master_weight"):
            np.testing.assert_allclose(accs[name].numpy(),
                                       np.asarray(jaccs[name]), rtol=RTOL,
                                       atol=ATOL)
        assert torch.equal(p.detach(),
                           accs["master_weight"].to(torch.bfloat16))


def test_multi_precision_keeps_fp32_masters():
    params, grads = _arrays(seed=3, steps=3)
    kw = {"learning_rate": 1e-2, "multi_precision": True}
    jps = [Parameter(jnp.asarray(p).astype(jnp.bfloat16)) for p in params]
    jopt = paddle.optimizer.AdamW(parameters=jps, **kw)
    for gs in grads:
        for p, g in zip(jps, gs):
            p.grad = Tensor(jnp.asarray(g).astype(jnp.bfloat16))
        jopt.step()
    got, opt = _port_run("AdamW", kw, params, grads, dtype=torch.bfloat16)
    for p, jp in zip(got, jps):
        assert p.dtype == torch.bfloat16
        master = opt._get_accumulators(p)["master_weight"]
        jmaster = np.asarray(jopt._get_accumulators(jp)["master_weight"])
        assert master.dtype == torch.float32
        assert opt._get_accumulators(p)["moment1"].dtype == torch.float32
        np.testing.assert_allclose(master.numpy(), jmaster, rtol=RTOL,
                                   atol=ATOL)
        # the parameter is its master rounded to bf16
        assert torch.equal(p.detach(), master.to(torch.bfloat16))


def test_state_dict_round_trip():
    params, grads = _arrays(seed=4, steps=3)
    names = ["a.w", "a.b", None]
    kw = {"learning_rate": 1e-2}
    ps, opt = _port_run("AdamW", kw, params, grads[:2], names)
    state = opt.state_dict()
    assert state["@step"] == 2
    assert sorted(k for k in state if k.startswith("a.w.")) == [
        "a.w.beta1_pow", "a.w.beta2_pow", "a.w.moment1", "a.w.moment2"]
    assert "param_2.moment1" in state
    # a fresh optimizer resumed from the state steps exactly like the
    # original one
    ps2 = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    opt2 = port_opt.AdamW(parameters=list(zip(names, ps2)), **kw)
    opt2.set_state_dict({k: (v.clone() if torch.is_tensor(v) else v)
                         for k, v in state.items()})
    assert opt2._step_count == 2
    for p, p2, g in zip(ps, ps2, grads[2]):
        p.grad = torch.from_numpy(g)
        p2.grad = torch.from_numpy(g)
    opt.step()
    opt2.step()
    for p, p2 in zip(ps, ps2):
        assert torch.equal(p, p2)


def test_learning_rate_rules():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = port_opt.SGD(learning_rate=0.5, parameters=[p])
    assert opt.get_lr() == 0.5
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25
    # a scheduler drives get_lr, and set_lr raises under it
    sched = port_opt.lr.StepDecay(0.5, step_size=1, gamma=0.5)
    opt.set_lr_scheduler(sched)
    assert opt.get_lr() == 0.5
    sched.step()
    assert opt.get_lr() == 0.25
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    with pytest.raises(ValueError):
        port_opt.SGD(learning_rate=0.1)
    p.grad = torch.ones(3)
    opt.clear_grad()
    assert p.grad is None


CLIPS = {
    "value": ("ClipGradByValue", (0.3,)),
    "value_asym": ("ClipGradByValue", (0.5, -0.1)),
    "norm": ("ClipGradByNorm", (1.0,)),
    "global_norm": ("ClipGradByGlobalNorm", (1.5,)),
    "global_norm_loose": ("ClipGradByGlobalNorm", (1e3,)),
}


@pytest.mark.parametrize("which", list(CLIPS))
def test_clip_matches_jax(which):
    cls, args = CLIPS[which]
    _, grads = _arrays(seed=5, steps=1)
    grads = grads[0]
    jclip = getattr(paddle.nn, cls)(*args)
    pclip = getattr(port_clip, cls)(*args)
    want = jclip([(None, Tensor(jnp.asarray(g))) for g in grads] +
                 [(None, None)])
    got = pclip([(None, torch.from_numpy(g)) for g in grads] +
                [(None, None)])
    assert got[-1][1] is None
    for (_, g), (_, w) in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._value),
                                   rtol=RTOL, atol=ATOL)
    # the train step's functional form, against the JAX step's
    fwant = jax_functional_clip(jclip, [jnp.asarray(g) for g in grads])
    fgot = _functional_clip(pclip, [torch.from_numpy(g) for g in grads])
    for g, w in zip(fgot, fwant):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_step_applies_the_clip():
    params, grads = _arrays(seed=6, steps=1)
    jclip = paddle.nn.ClipGradByGlobalNorm(0.5)
    want, _ = _jax_run("SGD", {"learning_rate": 0.1, "grad_clip": jclip},
                       params, grads)
    clip = port_clip.ClipGradByGlobalNorm(0.5)
    got, _ = _port_run("SGD", {"learning_rate": 0.1, "grad_clip": clip},
                       params, grads)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL)
