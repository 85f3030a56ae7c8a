"""Hybrid parallelism end to end at four ranks (mp 2 x sharding 2), gloo
on the CPU, launched once for the file: the port's counterpart of
``tests/test_fleet_e2e.py:35-66``, which drives the JAX package at dp 2 x
mp 2 x sharding 2.

- ``fleet.init``: the mesh's groups (mp pairs, sharding pairs, the data
  axes) by the reference's rank order; the facade's queries and
  ``process_local_batch``/``replicated_batch``'s contracts.
- ``Model.fit`` over ``fleet.distributed_model`` (a ``DataParallel`` over
  the data axes) and ``fleet.distributed_optimizer`` (ZeRO-1 over the
  sharding axis, the hybrid clip) of a column-then-row TP network: the
  loss drops below 0.8 of a fresh model's, the parameters are bit-equal
  across the ranks of each data group (and the replicated row bias
  across all four), and within 1e-5 of their largest entry of one
  process fitting the same batches.
- The eager path (``backward`` through the ``DataParallel``, the
  ``HybridParallelOptimizer``'s ZeRO-1 step) equals the compiled step.
- TP x ZeRO-3: the TP GPT under ``group_sharded_parallel(..., "p_g_os")``
  (ZeRO rows of each rank's TP piece), each sharding rank on half the
  batch: the loss, every gathered gradient and the updated parameters
  (PR 14's AdamW first-step rule) against the JAX package's TP GPT on
  its mp-2 mesh, and the second step's loss.

Tolerances, fp32: the loss within 1e-5 of itself; each gradient and
parameter within 1e-5 of its largest entry.
"""
import numpy as np
import pytest

from _torch_hybrid_helpers import (assert_check, gpt_reference,
                                   param_rule_err, rel_err, run_ranks)

TOL = 1e-5
NPROC = 4

_WORKER = """
import hashlib

import paddle_tpu_torch as paddle
from paddle_tpu_torch.convert import load_jax_state, slice_gpt_state
from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining

hcg = fleet.get_hybrid_communicate_group()
seen = []
dist.all_gather_object(seen, {
    "mp": hcg.get_model_parallel_group().ranks,
    "sharding": hcg.get_sharding_parallel_group().ranks,
    "data": MESH.group("dp", "sharding").ranks, "coord": MESH.coord})
out = {"groups": json.dumps(seen)}
ok("groups")

# the facade's queries, process_local_batch and replicated_batch
from paddle_tpu_torch.distributed import sharding_api as sa
assert fleet.worker_index() == RANK and fleet.worker_num() == 4
fleet.barrier_worker()
assert sa.process_local_batch(torch.ones(2, 4)).shape == (2, 4)
ragged = torch.ones(2 + MESH.coord["sharding"], 4)
try:
    sa.process_local_batch(ragged)
    raise AssertionError("a ragged batch was taken")
except ValueError as e:
    assert "[2, 2, 3, 3]" in str(e), e
sa.replicated_batch(torch.ones(3))
try:
    sa.replicated_batch(torch.full((3,), float(RANK)))
    raise AssertionError("different batches were taken as replicated")
except ValueError:
    pass
ok("facade")


class Ds(paddle.io.Dataset):
    def __init__(self, n=64):
        rng = np.random.default_rng(21)
        self.x = rng.uniform(-1, 1, (n, 32)).astype("float32")
        w = rng.uniform(-1, 1, (32, 4)).astype("float32")
        self.y = (self.x @ w + 0.05 * rng.standard_normal((n, 4))
                  ).astype("float32")

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def tp_net():
    g = torch.Generator().manual_seed(0)
    return torch.nn.Sequential(
        mpar.ColumnParallelLinear(32, 64, gather_output=False, device="cpu",
                                  generator=g),
        torch.nn.ReLU(),
        mpar.RowParallelLinear(64, 4, input_is_parallel=True, device="cpu",
                               generator=g))


def mse(net, x, y):
    with torch.no_grad():
        return float(((net(x) - y) ** 2).mean())


def mse_loss(out, y):
    return ((out - y) ** 2).mean()


net = tp_net()
ds = Ds()
x, y = torch.from_numpy(ds.x[:16]), torch.from_numpy(ds.y[:16])
fresh = mse(net, x, y)
opt = Adam(learning_rate=0.01, parameters=net.parameters())
model = paddle.Model(fleet.distributed_model(net))
model.prepare(optimizer=fleet.distributed_optimizer(opt), loss=mse_loss)
model.fit(ds, batch_size=16, epochs=3, verbose=0, shuffle=False)
out["fit/final"] = mse(net, x, y)
out["fit/fresh"] = fresh
digests = []
dist.all_gather_object(digests, (MESH.coord["mp"], [
    hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
    for p in net.parameters()]))
out["fit/digests"] = json.dumps(digests)
for n, p in net.named_parameters():
    out[f"fit/param/{n}"] = gather_global(p).numpy()
fleet.save_persistables(net, DATA)
fleet.barrier_worker()
ok("fit")

# the eager path (backward through the DataParallel's buckets, then the
# HybridParallelOptimizer's ZeRO-1 step) against the compiled step
nets = [tp_net(), tp_net()]
opts = [fleet.distributed_optimizer(Adam(learning_rate=0.01,
                                         parameters=n.parameters()))
        for n in nets]
rows = slice(16 * MESH.coord["sharding"], 16 * MESH.coord["sharding"] + 16)
xb, yb = torch.from_numpy(ds.x[rows]), torch.from_numpy(ds.y[rows])
dp = fleet.distributed_model(nets[0])
mse_loss(dp(xb), yb).backward()
opts[0].step()
CompiledTrainStep(lambda a, b: mse_loss(nets[1](a), b), nets[1],
                  opts[1])(xb, yb)
for (n, a), b in zip(nets[0].named_parameters(), nets[1].parameters()):
    assert torch.allclose(a, b, rtol=0, atol=1e-6), n
ok("eager")

# TP x ZeRO-3 GPT
G = np.load(f"{DATA}/gpt.npz")
state = {k[6:]: G[k] for k in G.files if k.startswith("state/")}
ids, labels = torch.from_numpy(G["ids"]), torch.from_numpy(G["labels"])
KW = json.loads(str(G["kw"]))
m = GPTForPretraining(GPTConfig(tensor_parallel=True, **KW), device="cpu")
load_jax_state(m, slice_gpt_state(state, 2, MESH.coord["mp"]))
opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
net2, opt2, _ = group_sharded_parallel(m, opt, "p_g_os")
step = CompiledTrainStep(lambda a, b: net2(a, labels=b)[1], m,
                         getattr(opt2, "_optim", opt2))
real = step._sync
grads = {}
step._sync = lambda g: grads.setdefault("g", real(g))
half = slice(2 * MESH.coord["sharding"], 2 * MESH.coord["sharding"] + 2)
losses = []
dist.all_gather_object(losses, float(step(ids[half], labels[half])))
out["gpt/loss1"] = sum(losses) / len(losses)
for (n, p), g in zip(m.named_parameters(), grads["g"]):
    out[f"gpt/grad/{n}"] = gather_global(g, placement_of(p)).numpy()
    out[f"gpt/param/{n}"] = gather_global(p).numpy()
    assert p._zero is None or p.shape[0] == p._zero.hi - p._zero.lo
losses = []
dist.all_gather_object(losses, float(step(ids[half], labels[half])))
out["gpt/loss2"] = sum(losses) / len(losses)
ok("tp_zero3")
if RANK == 0:
    np.savez(f"{DATA}/port.npz", **out)
ok("saved")
"""


def _one_process_fit():
    """The same network whole in one process (a mesh of one), fitting the
    64 rows in batches of 32: the two data ranks' 16 each."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import sharding_api as sa
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar
    from paddle_tpu_torch.optimizer import Adam
    rng = np.random.default_rng(21)
    xs = rng.uniform(-1, 1, (64, 32)).astype("float32")
    w = rng.uniform(-1, 1, (32, 4)).astype("float32")
    ys = (xs @ w + 0.05 * rng.standard_normal((64, 4))).astype("float32")
    g = torch.Generator().manual_seed(0)
    sa.set_default_mesh(sa.Mesh((1, 1, 1, 1, 1), rank=0))
    try:
        net = torch.nn.Sequential(
            mpar.ColumnParallelLinear(32, 64, gather_output=False,
                                      device="cpu", generator=g),
            torch.nn.ReLU(),
            mpar.RowParallelLinear(64, 4, input_is_parallel=True,
                                   device="cpu", generator=g))
    finally:
        sa.set_default_mesh(None)
    opt = Adam(learning_rate=0.01, parameters=net.parameters())
    model = paddle.Model(net)
    model.prepare(optimizer=opt, loss=lambda out, t: ((out - t) ** 2).mean())
    # DistributedBatchSampler without shuffle: rank r takes rows r, r+2,
    # r+4, ... in batches of 16; step k averages rows 32k .. 32k+31
    data = paddle.io.TensorDataset([torch.from_numpy(xs),
                                    torch.from_numpy(ys)])
    model.fit(paddle.io.DataLoader(data, batch_size=32, shuffle=False),
              epochs=3, verbose=0)
    return {n: p.detach().numpy() for n, p in net.named_parameters()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import os
    d = tmp_path_factory.mktemp("hybrid_fit")
    old = os.environ.get("PDTPU_PALLAS_INTERPRET")
    os.environ["PDTPU_PALLAS_INTERPRET"] = "0"
    try:
        gpt = gpt_reference(d)
    finally:
        if old is None:
            os.environ.pop("PDTPU_PALLAS_INTERPRET", None)
        else:
            os.environ["PDTPU_PALLAS_INTERPRET"] = old
    logs = run_ranks(d, _WORKER, {"dp_degree": 1, "mp_degree": 2,
                                  "sharding_degree": 2}, nproc=NPROC,
                     timeout=300)
    return {"logs": logs, "gpt": gpt, "port": dict(np.load(d / "port.npz")),
            "dir": d}


def test_fleet_groups_at_four_ranks(run):
    import json
    assert_check(run["logs"], "groups", NPROC)
    seen = json.loads(str(run["port"]["groups"]))
    # the reference's order: rank = sharding * 2 + mp (dp, pp, sep of 1)
    for r, g in enumerate(seen):
        assert g["coord"]["mp"] == r % 2 and g["coord"]["sharding"] == r // 2
        assert g["mp"] == [r - r % 2, r - r % 2 + 1]
        assert g["sharding"] == [r % 2, r % 2 + 2]
        assert g["data"] == g["sharding"]


def test_facade_queries_and_batch_contracts(run):
    """``worker_index``/``worker_num``/``barrier_worker``;
    ``process_local_batch`` keeps each rank's rows and names the ranks'
    counts when they differ; ``replicated_batch`` refuses ranks that hold
    different batches."""
    assert_check(run["logs"], "facade", NPROC)


def test_save_persistables_writes_the_first_workers_state(run):
    import paddle_tpu_torch as paddle
    state = paddle.load(str(run["dir"] / "persistables.pdparams"),
                        return_numpy=True)
    # rank 0's pieces: half the columns of the first weight, whole bias 2
    assert state["0.weight"].shape == (32, 32)
    np.testing.assert_array_equal(
        state["0.weight"], run["port"]["fit/param/0.weight"][:, :32])
    assert state["2.bias"].shape == (4,)


def test_fit_loss_drops(run):
    assert_check(run["logs"], "fit", NPROC)
    port = run["port"]
    assert port["fit/final"] < 0.8 * port["fit/fresh"], \
        (port["fit/final"], port["fit/fresh"])


def test_fit_ranks_bit_equal_within_data_groups(run):
    import json
    digests = json.loads(str(run["port"]["fit/digests"]))
    for mp in (0, 1):
        rows = [d for c, d in digests if c == mp]
        assert len(rows) == 2 and rows[0] == rows[1]
    # the row bias is replicated over every axis
    assert len({d[-1] for _, d in digests}) == 1


def test_eager_hybrid_optimizer_step_equals_the_compiled_step(run):
    assert_check(run["logs"], "eager", NPROC)


def test_fit_matches_one_process(run):
    want = _one_process_fit()
    for n, w in want.items():
        got = run["port"][f"fit/param/{n}"]
        assert got.shape == w.shape, n
        assert rel_err(got, w) <= TOL, (n, rel_err(got, w))


def test_tp_zero3_gpt_step_matches_jax(run):
    assert_check(run["logs"], "tp_zero3", NPROC)
    gpt, port = run["gpt"], run["port"]
    assert abs(port["gpt/loss1"] - gpt["loss1"]) <= TOL * gpt["loss1"]
    assert abs(port["gpt/loss2"] - gpt["loss2"]) <= TOL * gpt["loss2"]
    for n, want in gpt["grads"].items():
        got = port[f"gpt/grad/{n}"]
        assert got.shape == want.shape, n
        assert rel_err(got, want) <= TOL, (n, rel_err(got, want))
        err = param_rule_err(port[f"gpt/param/{n}"], gpt["params"][n], got,
                             want)
        assert err <= TOL, (n, err)
