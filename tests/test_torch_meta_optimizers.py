"""The port's fleet meta-optimizers (``paddle_tpu_torch/distributed/fleet/
meta_optimizers.py``), their place in ``CompiledTrainStep``, and
``ClipGradByNorm`` over split parameters (``fleet/meta_parallel/
sharding.py``), against the JAX package's.

In one process, on seeded numpy parameters and gradients planted into
both packages:

- ``GradientMergeOptimizer`` (k 3, AdamW, ``avg`` on and off): the
  return values of six calls and the parameters after them (rtol 1e-6),
  as ``tests/test_flags_and_dp.py:187-201`` uses it.
- ``DGCOptimizer`` (momentum 0.9, sparsity 0.8, ramp-up 2): over 20
  steps, each step's sent entries (the mask) equal to the reference's,
  with a step whose |v| ties at the threshold planted, and the
  parameters within 1e-6.
- ``LocalSGDOptimizer`` in a world of one process: the inner step's
  parameters, the sync the identity.
- ``CompiledTrainStep`` with a DGC or LocalSGD wrapper: a ``UserWarning``
  naming it and a training run on the inner optimizer
  (``tests/test_fleet_e2e.py:78-110``); with a GradientMerge wrapper:
  three calls and a three-step ``run_steps`` block, parameters within
  1e-6 of the reference's largest entry and the step counts where the
  reference leaves them (on the wrapper, not the inner optimizer).

Across two gloo ranks on the CPU (launched once for the file): LocalSGD
(k 1, SGD) against one process's step on the two ranks' rows, and at k 4
with AdamW, the parameters bit-equal across the ranks right after each
sync; DGC with ramp-up 0, sparsity 0 and momentum 0 against one
process's SGD step, and at sparsity 0.9 each rank's send within
⌊numel·0.1⌋ entries plus ties, the averaged gradient within twice that,
the ranks bit-equal; ``CompiledTrainStep`` with ``ClipGradByNorm`` on a
tensor-parallel MLP at mp 2 and under ZeRO-3 at sharding 2, each within
1e-5 of one process's step (fp32).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import meta_optimizers as jmeta
from paddle_tpu.tensor import Parameter, Tensor

from _torch_hybrid_helpers import assert_check, rel_err, run_ranks, save_npz
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.distributed.fleet import meta_optimizers as tmeta
from paddle_tpu_torch.jit import CompiledTrainStep as TStep

RTOL = 1e-6
TOL = 1e-5
SHAPES = [(6, 5), (5,), (40,)]


def _jax_params(arrays):
    return [Parameter(jnp.asarray(a)) for a in arrays]


def _port_params(arrays):
    return [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]


def _draws(seed, steps, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    return params, grads


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-9)


def _near(got, want):
    """A compiled step against an eager one: within 1e-6 of the largest
    entry."""
    assert rel_err(np.asarray(got), np.asarray(want)) <= RTOL


@pytest.mark.parametrize("avg", [True, False])
def test_gradient_merge_applies_every_k(avg):
    params, grads = _draws(0, 6)
    jp, tp = _jax_params(params), _port_params(params)
    jopt = jmeta.GradientMergeOptimizer(
        paddle.optimizer.AdamW(learning_rate=1e-2, parameters=jp),
        k_steps=3, avg=avg)
    topt = tmeta.GradientMergeOptimizer(
        port_opt.AdamW(learning_rate=1e-2, parameters=tp), k_steps=3,
        avg=avg)
    jret, tret = [], []
    for gs in grads:
        for a, b, g in zip(jp, tp, gs):
            a.grad = Tensor(jnp.asarray(g))
            b.grad = torch.from_numpy(g)
        jret.append(jopt.step())
        tret.append(topt.step())
        for a, b in zip(jp, tp):
            _close(b.detach(), a._value)
        if not tret[-1]:
            assert all(b.grad is None for b in tp)
    assert tret == jret == [False, False, True] * 2
    assert not np.allclose(tp[0].detach().numpy(), params[0])


def _dgc_grads():
    """20 steps of gradients; step 7 plants a tie at the threshold of the
    [40] parameter (k = 8: six entries of |3|, then four of |2|)."""
    params, grads = _draws(1, 20)
    tie = np.full(40, 0.125, np.float32)
    tie[:6] = [3.0, -3.0, 3.0, 3.0, -3.0, 3.0]
    tie[[10, 20, 30, 39]] = [2.0, -2.0, 2.0, -2.0]
    grads[7][2] = tie
    return params, grads


def test_dgc_masks_and_parameters_match_the_reference():
    params, grads = _dgc_grads()
    jp, tp = _jax_params(params), _port_params(params)
    kw = dict(momentum=0.9, sparsity=0.8, rampup_begin_step=2)
    jopt = jmeta.DGCOptimizer(
        paddle.optimizer.SGD(learning_rate=0.05, parameters=jp), **kw)
    topt = tmeta.DGCOptimizer(
        port_opt.SGD(learning_rate=0.05, parameters=tp), **kw)
    tied = None
    for t, gs in enumerate(grads):
        if t == 7:
            # the tie: v restarts at the planted gradient
            for a, b in zip(jp, tp):
                jopt._v.pop(id(a), None), jopt._u.pop(id(a), None)
                topt._v.pop(id(b), None), topt._u.pop(id(b), None)
        for a, b, g in zip(jp, tp, gs):
            a.grad = Tensor(jnp.asarray(g))
            b.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
        for a, b in zip(jp, tp):
            jsend, tsend = np.asarray(a.grad._value), b.grad.numpy()
            np.testing.assert_array_equal(tsend != 0, jsend != 0)
            _close(tsend, jsend)
            _close(b.detach(), a._value)
            if t == 7 and b.shape == (40,):
                tied = tsend
    # k = 8 of 40, and every entry tied with the eighth goes too
    assert tied is not None and int((tied != 0).sum()) == 10
    for a, b in zip(jp, tp):
        _close(topt._v[id(b)].numpy(), jopt._v[id(a)])
        _close(topt._u[id(b)].numpy(), jopt._u[id(a)])


def test_dgc_mask_keeps_every_tie():
    opt = tmeta.DGCOptimizer(port_opt.SGD(
        learning_rate=0.1, parameters=_port_params([np.zeros(6,
                                                             np.float32)])),
        sparsity=0.5)
    v = torch.tensor([1.0, -3.0, 3.0, 3.0, 0.5, 0.0])
    # k = 3: the third largest |v| is 3.0, so all three 3.0s go; an
    # all-zero v sends nothing (the 1e-30 floor)
    assert opt.mask(v).tolist() == [0.0, 1.0, 1.0, 1.0, 0.0, 0.0]
    assert opt.mask(torch.zeros(6)).sum() == 0


def test_local_sgd_in_one_process_is_the_inner_step():
    params, grads = _draws(2, 4)
    jp, tp = _jax_params(params), _port_params(params)
    jopt = jmeta.LocalSGDOptimizer(paddle.optimizer.SGD(
        learning_rate=0.1, parameters=jp), k_steps=2)
    topt = tmeta.LocalSGDOptimizer(port_opt.SGD(
        learning_rate=0.1, parameters=tp), k_steps=2)
    for gs in grads:
        for a, b, g in zip(jp, tp, gs):
            a.grad = Tensor(jnp.asarray(g))
            b.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        assert all(b.grad is None for b in tp)
    for a, b in zip(jp, tp):
        _close(b.detach(), a._value)
    assert topt._count == 4 and topt.get_lr() == 0.1


def _linear_pair(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 4)).astype(np.float32) * 0.5
    b = rng.standard_normal(4).astype(np.float32) * 0.1
    jnet = paddle.nn.Linear(4, 4)
    jnet.weight._value, jnet.bias._value = jnp.asarray(w), jnp.asarray(b)
    tnet = tnn.Linear(4, 4, device="cpu")
    with torch.no_grad():
        tnet.weight.copy_(torch.from_numpy(w))
        tnet.bias.copy_(torch.from_numpy(b))
    return jnet, tnet


@pytest.mark.parametrize("wrapper", ["DGCOptimizer", "LocalSGDOptimizer"])
def test_compiled_step_warns_and_runs_the_inner_optimizer(wrapper):
    jnet, tnet = _linear_pair()
    from paddle_tpu.jit.train_step import CompiledTrainStep as JStep
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 4)).astype(np.float32)
    steps = {}
    for pkg, net, opt_mod, meta, Step in (
            ("jax", jnet, paddle.optimizer, jmeta, JStep),
            ("port", tnet, port_opt, tmeta, TStep)):
        opt = getattr(meta, wrapper)(opt_mod.SGD(
            learning_rate=0.1, parameters=net.parameters()))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if pkg == "jax":
                step = Step(lambda a, b, n=net: paddle.mean(
                    paddle.square(n(a) - b)), net, opt)
            else:
                step = Step(lambda a, b, n=net: ((n(a) - b) ** 2).mean(),
                            net, opt)
        msgs = [str(w.message) for w in caught
                if issubclass(w.category, UserWarning)]
        assert any(wrapper in m for m in msgs), (pkg, msgs)
        assert step.optimizer is opt._inner
        steps[pkg] = step
    losses = {"jax": [], "port": []}
    for _ in range(6):
        losses["jax"].append(float(np.asarray(steps["jax"](
            paddle.to_tensor(x), paddle.to_tensor(y))._value)))
        losses["port"].append(float(steps["port"](torch.from_numpy(x),
                                                   torch.from_numpy(y))))
    assert losses["port"][-1] < losses["port"][0]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    _close(tnet.weight.detach(), jnet.weight._value, rtol=1e-5)


def test_gradient_merge_under_the_compiled_step_follows_the_reference():
    """The reference does not unwrap GradientMerge: every call applies the
    inner optimizer, and the step's counters land on the wrapper."""
    from paddle_tpu.jit.train_step import CompiledTrainStep as JStep
    jnet, tnet = _linear_pair(1)
    jin = paddle.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=jnet.parameters())
    tin = port_opt.AdamW(learning_rate=1e-2, parameters=tnet.parameters())
    jopt = jmeta.GradientMergeOptimizer(jin, k_steps=4)
    topt = tmeta.GradientMergeOptimizer(tin, k_steps=4)
    jstep = JStep(lambda a, b: paddle.mean(paddle.square(jnet(a) - b)),
                  jnet, jopt, donate=False)
    tstep = TStep(lambda a, b: ((tnet(a) - b) ** 2).mean(), tnet, topt)
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((6, 8, 4)).astype(np.float32)
    ys = rng.standard_normal((6, 8, 4)).astype(np.float32)
    for i in range(3):
        jstep(paddle.to_tensor(xs[i]), paddle.to_tensor(ys[i]))
        tstep(torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
        _near(tnet.weight.detach(), jnet.weight._value)
    jl = jstep.run_steps(paddle.to_tensor(xs[3:]), paddle.to_tensor(ys[3:]))
    tl = tstep.run_steps(torch.from_numpy(xs[3:]), torch.from_numpy(ys[3:]))
    _near(tl, jl._value)
    for a, b in ((jnet.weight, tnet.weight), (jnet.bias, tnet.bias)):
        _near(b.detach(), a._value)
    # six updates, none merged; the counters where the reference puts them
    assert (topt.__dict__.get("_step_count"), tin._step_count) == \
        (jopt.__dict__.get("_step_count"), jin._step_count) == (6, 0)
    assert topt._count == jopt._count == 0


# -- two gloo ranks ------------------------------------------------------------
_WORKER = """
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.distributed.sharding_api import (build_mesh,
                                                       set_default_mesh)
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn.clip import ClipGradByNorm
from paddle_tpu_torch.optimizer import SGD, AdamW

D = np.load(f"{DATA}/inputs.npz")
x, y = torch.from_numpy(D["x"]), torch.from_numpy(D["y"])
rows = slice(4 * RANK, 4 * RANK + 4)
out = {}


def mlp():
    net = torch.nn.Sequential(nn.Linear(8, 12, device="cpu"),
                              torch.nn.Tanh(),
                              nn.Linear(12, 8, device="cpu"))
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(D["state/" + n]))
    return net


def loss_of(net, a, b):
    return ((net(a) - b) ** 2).mean()


def flat(net):
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()])


def same_on_ranks(t):
    seen = []
    dist.all_gather_object(seen, t.numpy().tobytes())
    return seen[0] == seen[1]


# LocalSGD at k 1 with SGD: the average of the local steps
net = mlp()
opt = meta.LocalSGDOptimizer(SGD(learning_rate=0.1,
                                 parameters=net.parameters()), k_steps=1)
loss_of(net, x[rows], y[rows]).backward()
opt.step()
out["localsgd_k1"] = flat(net).numpy()
ok("localsgd_k1")

# LocalSGD at k 4 with AdamW: the ranks differ between syncs and are
# bit-equal right after each
net = mlp()
opt = meta.LocalSGDOptimizer(AdamW(learning_rate=1e-2,
                                   parameters=net.parameters()), k_steps=4)
pattern = []
for i in range(8):
    loss_of(net, x[rows], y[rows] * (1 + i)).backward()
    opt.step()
    opt.clear_grad()
    pattern.append(same_on_ranks(flat(net)))
assert pattern == [False, False, False, True] * 2, pattern
ok("localsgd_k4")

# DGC with ramp-up 0, sparsity 0 and momentum 0: the data-parallel step
net = mlp()
opt = meta.DGCOptimizer(SGD(learning_rate=0.1, parameters=net.parameters()),
                        momentum=0.0, sparsity=0.0, rampup_begin_step=0)
loss_of(net, x[rows], y[rows]).backward()
opt.step()
out["dgc_dense"] = flat(net).numpy()
ok("dgc_dense")

# DGC at sparsity 0.9: sparse sends, averaged, the ranks equal
net = mlp()
opt = meta.DGCOptimizer(SGD(learning_rate=0.01, parameters=net.parameters()),
                        momentum=0.9, sparsity=0.9, rampup_begin_step=1)
for i in range(4):
    loss_of(net, x[rows], y[rows]).backward()
    if i >= 1:
        sends = {}
        for p in net.parameters():
            u = opt._u.get(id(p))
            u = p.grad.clone() if u is None else opt.momentum * u + p.grad
            v = opt._v.get(id(p))
            v = u.clone() if v is None else v + u
            sends[id(p)] = int((opt.mask(v) != 0).sum())
    opt.step()
    if i >= 1:
        for p in net.parameters():
            k = max(int(p.numel() * (1 - 0.9)), 1)
            assert sends[id(p)] >= k, (sends[id(p)], k)
            out[f"dgc_nnz/{i}/{p.numel()}/{RANK}"] = np.array(
                [sends[id(p)], int((p.grad != 0).sum()), k])
    assert same_on_ranks(flat(net))
    opt.clear_grad()
ok("dgc_sparse")

# ClipGradByNorm on a tensor-parallel MLP at mp 2
set_default_mesh(build_mesh(mp=2))
col = mpar.ColumnParallelLinear(8, 12, gather_output=False, device="cpu")
row = mpar.RowParallelLinear(12, 8, input_is_parallel=True, device="cpu")
with torch.no_grad():
    for p, key in ((col.weight, "0.weight"), (col.bias, "0.bias"),
                   (row.weight, "2.weight"), (row.bias, "2.bias")):
        full, pl = D["state/" + key], placement_of(p)
        p.copy_(torch.from_numpy(full if pl is None else pl.take(full)))
tp = torch.nn.Sequential(col, torch.nn.Tanh(), row)
opt = SGD(learning_rate=0.5, parameters=tp.parameters(),
          grad_clip=ClipGradByNorm(0.05))
CompiledTrainStep(lambda a, b: loss_of(tp, a, b), tp, opt)(x, y)
for key, p in (("0.weight", col.weight), ("0.bias", col.bias),
               ("2.weight", row.weight), ("2.bias", row.bias)):
    out["tp_clip/" + key] = gather_global(p).numpy()
ok("tp_clip")

# ClipGradByNorm under ZeRO-3 at sharding 2, each rank on its rows
set_default_mesh(build_mesh(sharding=2))
net = mlp()
opt = SGD(learning_rate=0.5, parameters=net.parameters(),
          grad_clip=ClipGradByNorm(0.05))
net3, opt3, _ = group_sharded_parallel(net, opt, "p_g_os")
CompiledTrainStep(lambda a, b: loss_of(net3, a, b), net,
                  getattr(opt3, "_optim", opt3))(x[rows], y[rows])
for n, p in net.named_parameters():
    out["zero3_clip/" + n] = gather_global(p).numpy()
ok("zero3_clip")
np.savez(f"{DATA}/port_{RANK}.npz", **out)
ok("saved")
"""


def _one_process(state, x, y, steps):
    """The MLP's parameters after ``steps`` (a callable taking the net)."""
    net = torch.nn.Sequential(tnn.Linear(8, 12, device="cpu"),
                              torch.nn.Tanh(), tnn.Linear(12, 8,
                                                          device="cpu"))
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(state[n]))
    steps(net)
    return net


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("meta_optimizers")
    rng = np.random.default_rng(7)
    state = {"0.weight": rng.standard_normal((8, 12)).astype(np.float32),
             "0.bias": rng.standard_normal(12).astype(np.float32),
             "2.weight": rng.standard_normal((12, 8)).astype(np.float32),
             "2.bias": rng.standard_normal(8).astype(np.float32)}
    x = rng.standard_normal((8, 8)).astype(np.float32)
    y = rng.standard_normal((8, 8)).astype(np.float32)
    save_npz(d / "inputs.npz", x=x, y=y,
             **{f"state/{k}": v for k, v in state.items()})
    logs = run_ranks(d, _WORKER, {"dp_degree": 2})
    port = [dict(np.load(d / f"port_{r}.npz")) for r in range(2)]
    return {"logs": logs, "port": port, "state": state, "x": x, "y": y}


def _sgd_step(ranks, lr=0.1, clip=None):
    x, y = torch.from_numpy(ranks["x"]), torch.from_numpy(ranks["y"])

    def steps(net):
        opt = port_opt.SGD(learning_rate=lr, parameters=net.parameters(),
                           grad_clip=clip)
        ((net(x) - y) ** 2).mean().backward()
        opt.step()
    return _one_process(ranks["state"], x, y, steps)


@pytest.mark.parametrize("mode", ["localsgd_k1", "dgc_dense"])
def test_two_ranks_equal_one_process_sgd_step(ranks, mode):
    assert_check(ranks["logs"], mode)
    net = _sgd_step(ranks)
    want = torch.cat([p.detach().reshape(-1)
                      for p in net.parameters()]).numpy()
    for r in range(2):
        assert rel_err(ranks["port"][r][mode], want) <= TOL


def test_local_sgd_syncs_every_k(ranks):
    assert_check(ranks["logs"], "localsgd_k4")


def test_dgc_sends_are_sparse_and_ranks_agree(ranks):
    assert_check(ranks["logs"], "dgc_sparse")
    rows = [k for k in ranks["port"][0] if k.startswith("dgc_nnz/")]
    assert rows
    for key in rows:
        sent, averaged, k = ranks["port"][0][key]
        other = ranks["port"][1][key[:-1] + "1"]
        # ties aside, k entries a rank, at most the union of both
        assert sent <= k + 2 and averaged <= sent + other[0]


@pytest.mark.parametrize("case", ["tp_clip", "zero3_clip"])
def test_clip_by_norm_over_split_parameters_equals_one_process(ranks, case):
    from paddle_tpu_torch.nn.clip import ClipGradByNorm
    assert_check(ranks["logs"], case)
    net = _sgd_step(ranks, lr=0.5, clip=ClipGradByNorm(0.05))
    moved = 0
    for n, p in net.named_parameters():
        want = p.detach().numpy()
        moved += not np.allclose(want, ranks["state"][n])
        for r in range(2):
            assert rel_err(ranks["port"][r][f"{case}/{n}"], want) <= TOL, n
    assert moved == 4
