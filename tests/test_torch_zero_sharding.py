"""ZeRO stages 1 to 3 of the port (``fleet/meta_parallel/sharding.py``,
``distributed/sharding.py``) at sharding 2: two gloo ranks on the CPU,
launched once for the file, against the JAX package's
``group_sharded_parallel`` step on its sharding-2 mesh in this process.

- ``os``, ``os_g`` and ``p_g_os``: an MLP whose parameters both divide
  and do not divide over two ranks (dimension 0 of 33 stays whole), built
  as config 4 builds ERNIE (``group_sharded_parallel``, then
  ``CompiledTrainStep`` on the unwrapped net and ``getattr(opt,
  "_optim", opt)``), each rank on its half of the global batch: the two
  steps' losses (the ranks' mean) and every parameter after one and two
  AdamW steps against the reference's; the eager path (``backward``, the
  ZeRO optimizer's ``step``) the same after one step.
- ZeRO-3 frees a gathered parameter after use: the backward gathers it
  again (counted by the comm plane).
- Per-rank optimizer state: the sharded parameters' moments are half of
  one process's (the port's counterpart of
  ``tests/test_zero_sharding.py:49``); a ZeRO-3 rank stores half of each
  divisible parameter.
- ZeRO composed with TP (``tests/test_zero_sharding.py:109``): the spec
  rule on column and row weights, and the ZeRO rows of a TP piece mapped
  into the global tensor.
- ``save_group_sharded_model``: rank 0 writes the whole parameters and
  optimizer state, which load into one process.

Tolerances, fp32: the loss within 1e-5 of itself; each parameter within
1e-5 of its largest entry.
"""
import numpy as np
import pytest
import torch

from _torch_hybrid_helpers import (assert_check, rel_err, run_ranks,
                                   save_npz)

TOL = 1e-5
LEVELS = ("os", "os_g", "p_g_os")

_WORKER = """
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import comm_plane
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
    state_bytes)
from paddle_tpu_torch.distributed.sharding import (group_sharded_parallel,
                                                   save_group_sharded_model)
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.optimizer import AdamW

R = np.load(f"{DATA}/ref.npz")
x, y = torch.from_numpy(R["x"]), torch.from_numpy(R["y"])
rows = slice(4 * RANK, 4 * RANK + 4)
out = {}


def build():
    net = torch.nn.Sequential(nn.Linear(16, 33, device="cpu"),
                              torch.nn.Tanh(),
                              nn.Linear(33, 16, device="cpu"))
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(R["state/" + n]))
    return net


def params_of(net):
    return {n: gather_global(p).numpy() for n, p in net.named_parameters()}


def mean_loss(loss):
    seen = []
    dist.all_gather_object(seen, float(loss))
    return sum(seen) / len(seen)


plain_net = build()
plain = AdamW(learning_rate=1e-3, parameters=plain_net.parameters())
CompiledTrainStep(lambda a, b: ((plain_net(a) - b) ** 2).mean(), plain_net,
                  plain)(x[rows], y[rows])
plain_bytes = state_bytes(plain, list(plain_net.parameters()))

for level in ("os", "os_g", "p_g_os"):
    net = build()
    opt = AdamW(learning_rate=1e-3, parameters=net.parameters())
    net2, opt2, _ = group_sharded_parallel(net, opt, level)
    step = CompiledTrainStep(lambda a, b: ((net2(a) - b) ** 2).mean(), net,
                             getattr(opt2, "_optim", opt2))
    out[f"{level}/loss1"] = mean_loss(step(x[rows], y[rows]))
    for n, v in params_of(net).items():
        out[f"{level}/step1/{n}"] = v
    out[f"{level}/loss2"] = mean_loss(step(x[rows], y[rows]))
    for n, v in params_of(net).items():
        out[f"{level}/step2/{n}"] = v
    pb, ob = state_bytes(opt, list(net.parameters()))
    out[f"{level}/bytes"] = np.array([pb, ob, *plain_bytes])
    ok(f"compiled_{level}")

    # the eager path: backward, then the ZeRO optimizer's step
    net = build()
    opt = AdamW(learning_rate=1e-3, parameters=net.parameters())
    net2, opt2, _ = group_sharded_parallel(net, opt, level)
    loss = ((net2(x[rows].clone().requires_grad_(True)) - y[rows]) ** 2
            ).mean()
    before = comm_plane.get_plane().stats()["works"]
    loss.backward()
    out[f"{level}/backward_works"] = \
        comm_plane.get_plane().stats()["works"] - before
    opt2.step()
    for n, v in params_of(net).items():
        out[f"{level}/eager1/{n}"] = v
    ok(f"eager_{level}")

    if level == "p_g_os":
        save_group_sharded_model(net2, f"{DATA}/saved", opt2)
        for n, p in net.named_parameters():
            out[f"saved/{n}"] = p.detach().numpy().copy()
        ok("save")

if RANK == 0:
    np.savez(f"{DATA}/port.npz", **out)
ok("saved")
"""


def _reference(d):
    """The JAX package's ZeRO steps at sharding 2 over 2 CPU devices."""
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.meta_parallel.sharding import (
        group_sharded_parallel)
    from paddle_tpu.distributed.sharding_api import (build_mesh,
                                                     set_default_mesh)
    from paddle_tpu.jit.train_step import CompiledTrainStep
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.standard_normal((8, 16)).astype(np.float32)

    def build():
        paddle.seed(7)
        return paddle.nn.Sequential(paddle.nn.Linear(16, 33),
                                    paddle.nn.Tanh(),
                                    paddle.nn.Linear(33, 16))

    state = {k: np.asarray(v._value) for k, v in build().state_dict().items()}
    out = {}
    set_default_mesh(build_mesh(dp=1, sharding=2,
                                devices=jax.devices()[:2]))
    try:
        for level in LEVELS:
            net = build()
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=net.parameters())
            net2, opt2, _ = group_sharded_parallel(net, opt, level)
            step = CompiledTrainStep(
                lambda a, b, n=net2: paddle.mean((n(a) - b) ** 2), net,
                getattr(opt2, "_optim", opt2), donate=False)
            tx, ty = paddle.to_tensor(x), paddle.to_tensor(y)
            out[f"{level}/loss1"] = float(np.asarray(step(tx, ty)._value))
            out[f"{level}/step1"] = {k: np.asarray(v._value) for k, v in
                                     net.state_dict().items()}
            out[f"{level}/loss2"] = float(np.asarray(step(tx, ty)._value))
            out[f"{level}/step2"] = {k: np.asarray(v._value) for k, v in
                                     net.state_dict().items()}
    finally:
        set_default_mesh(None)
    save_npz(d / "ref.npz", x=x, y=y,
             **{f"state/{k}": v for k, v in state.items()})
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero")
    ref = _reference(d)
    logs = run_ranks(d, _WORKER, {"dp_degree": 1, "sharding_degree": 2})
    return {"logs": logs, "ref": ref, "port": dict(np.load(d / "port.npz")),
            "dir": d}


@pytest.mark.parametrize("level", LEVELS)
def test_zero_steps_match_jax(run, level):
    assert_check(run["logs"], f"compiled_{level}")
    ref, port = run["ref"], run["port"]
    for k in ("loss1", "loss2"):
        assert abs(port[f"{level}/{k}"] - ref[f"{level}/{k}"]) <= \
            TOL * abs(ref[f"{level}/{k}"]), k
    assert ref[f"{level}/loss2"] < ref[f"{level}/loss1"]
    for s in ("step1", "step2"):
        for n, want in ref[f"{level}/{s}"].items():
            got = port[f"{level}/{s}/{n}"]
            assert got.shape == want.shape, n
            assert rel_err(got, want) <= TOL, (s, n, rel_err(got, want))


@pytest.mark.parametrize("level", LEVELS)
def test_eager_zero_step_matches_jax(run, level):
    assert_check(run["logs"], f"eager_{level}")
    for n, want in run["ref"][f"{level}/step1"].items():
        got = run["port"][f"{level}/eager1/{n}"]
        assert rel_err(got, want) <= TOL, (n, rel_err(got, want))


@pytest.mark.parametrize("level", LEVELS)
def test_zero3_gathers_again_in_the_backward(run, level):
    """ZeRO-3 keeps no whole parameter for the backward: the first
    layer's weight, saved for the input's gradient, is gathered again
    there, and the two split gradients are reduce-scattered (three works
    of the comm plane); ZeRO-1/2 move nothing until the step."""
    works = int(run["port"][f"{level}/backward_works"])
    assert works == (3 if level == "p_g_os" else 0), works


@pytest.mark.parametrize("level", LEVELS)
def test_optimizer_state_per_rank_is_halved(run, level):
    pb, ob, plain_pb, plain_ob = run["port"][f"{level}/bytes"]
    # split over the two ranks: the [16, 33] weight and the [16] bias;
    # whole (dimension 0 of 33 does not divide): the [33] bias and the
    # [33, 16] weight
    whole = (33 + 33 * 16) * 4
    split = (16 * 33 + 16) * 4
    assert plain_ob == 2 * (whole + split) + 2 * 4 * 4   # m, v, beta pows
    assert ob == 2 * (whole + split // 2) + 2 * 4 * 4
    assert pb == (plain_pb if level != "p_g_os" else whole + split // 2)


def test_save_group_sharded_model_loads_whole(run):
    assert_check(run["logs"], "save")
    import paddle_tpu_torch as paddle
    d = run["dir"] / "saved"
    state = paddle.load(str(d / "model.pdparams"), return_numpy=True)
    opt_state = paddle.load(str(d / "model.pdopt"), return_numpy=True)
    for n, want in run["ref"]["p_g_os/step1"].items():
        assert state[n].shape == want.shape
        np.testing.assert_array_equal(state[n], run["port"][f"saved/{n}"])
        assert rel_err(state[n], want) <= TOL
    moments = [k for k in opt_state if k.endswith(".moment1")]
    assert len(moments) == 4
    for k in moments:
        shapes = {v.shape for n, v in state.items()}
        assert opt_state[k].shape in shapes


def test_zero_composes_with_tp():
    from paddle_tpu_torch.distributed import sharding_api as sa
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        shard_optimizer_state, zero_partition_spec)
    from paddle_tpu_torch.optimizer import AdamW
    whole_col = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    whole_row = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    try:
        for rank in range(4):
            # dp 1 x sharding 2 x mp 2 as a layout (no process group)
            mesh = sa.set_default_mesh(sa.Mesh((1, 1, 2, 1, 2), rank=rank))
            col = mpar.ColumnParallelLinear(8, 16, device="cpu")
            row = mpar.RowParallelLinear(16, 8, device="cpu")
            assert zero_partition_spec(col.weight, mesh) == ("sharding", "mp")
            assert zero_partition_spec(row.weight, mesh) == \
                (("mp", "sharding"), None)
            with torch.no_grad():
                col.weight.copy_(torch.from_numpy(
                    sa.placement_of(col.weight).take(whole_col)))
                row.weight.copy_(torch.from_numpy(
                    sa.placement_of(row.weight).take(whole_row)))
            opt = AdamW(parameters=[col.weight, row.weight])
            for p in (col.weight, row.weight):
                opt._get_accumulators(p)["moment1"].copy_(p.detach())
            shard_optimizer_state(opt, [col.weight, row.weight], "os", mesh)
            for p, whole in ((col.weight, whole_col), (row.weight,
                                                        whole_row)):
                m1 = opt._accumulators[id(p)]["moment1"]
                pl = sa.placement_of(m1)
                assert pl.axes == ("mp", "sharding")
                # the rows of the TP piece are these entries of the whole
                assert m1.shape[0] == p.shape[0] // 2
                np.testing.assert_array_equal(pl.take(whole), m1.numpy())
    finally:
        sa.set_default_mesh(None)
