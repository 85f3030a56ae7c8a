"""The eager ``PipelineParallel`` with tensor-parallel layers in its stages
(``ColumnParallelLinear``/``RowParallelLinear``), and under a ZeRO
optimizer, on the port, held to the port's one-process ``_local_train`` and
to the reference's step.

Four gloo ranks on the CPU, launched once for the file:

- ``fleet.init`` at pp 2 x mp 2 (rank = 2 pp + mp): a ``PipelineLayer`` of
  two stages, each ``ColumnParallelLinear(8, 16, gather_output=False)``,
  Tanh, ``RowParallelLinear(16, 8, input_is_parallel=True)``, an MSE loss,
  through ``fleet.distributed_model`` and ``fleet.distributed_optimizer``
  (SGD), 1F1B over 4 microbatches of an 8-row batch, two steps: the
  losses on every rank and each stage's parameters, gathered over mp,
  within 1e-6 of each one's largest entry of one process's
  ``_local_train`` in the rank (the same global weights on plain layers)
  and of the reference's ``PipelineParallel`` over its
  ``ColumnParallelLinear``/``RowParallelLinear`` on its mp-2 mesh of the
  session's virtual devices;
- ``fleet.init`` again at pp 2 x sharding 2: the same pipeline with the
  mp layers at mp 1, each sharding rank on its 4 rows in 2 microbatches,
  under ``fleet.distributed_optimizer`` (ZeRO-1: SGD's state and update
  sharded) and under ``group_sharded_parallel(..., "os_g")`` (ZeRO-2: the
  gradients reduce-scattered onto their rows): after
  ``_average_over_data_axes`` the optimizer's step must not change the
  averaged gradients (ZeRO-2's step averages the already equal gradients
  over sharding once more, which leaves them as they are); the losses
  averaged over the sharding ranks and the parameters after two steps
  within 1e-6 of one process on the whole batch and of the reference's
  step. (ZeRO-3 stores the parameters as rows gathered by its wrapper's
  forward, which the eager pipeline's schedule does not call.)"""
import numpy as np
import pytest

from _torch_hybrid_helpers import assert_check, rel_err, run_ranks

TOL = 1e-6
LR = 0.05

_WORKER = """
from types import SimpleNamespace
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel)
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
    group_sharded_parallel)
from paddle_tpu_torch.optimizer import SGD

W = np.load(f"{DATA}/inputs.npz")


def mse(o, y):
    return ((o - y) * (o - y)).mean()


def build(parallel):
    descs = []
    for _ in range(2):
        if parallel:
            descs += [LayerDesc(mpar.ColumnParallelLinear, 8, 16,
                                gather_output=False, device="cpu"),
                      LayerDesc(tnn.Tanh),
                      LayerDesc(mpar.RowParallelLinear, 16, 8,
                                input_is_parallel=True, device="cpu")]
        else:
            descs += [LayerDesc(tnn.Linear, 8, 16, device="cpu"),
                      LayerDesc(tnn.Tanh),
                      LayerDesc(tnn.Linear, 16, 8, device="cpu")]
    model = PipelineLayer(descs, num_stages=2, loss_fn=mse)
    with torch.no_grad():
        for name, p in model.named_parameters():
            full = W[f"w/{name}"]
            pl = placement_of(p)
            p.copy_(torch.from_numpy(pl.take(full) if pl is not None
                                     else full))
    return model


def gather_mp(p):
    # the whole parameter from the stage's mp ranks (gather_global gathers
    # over the world, whose other stage holds other tensors)
    pl = placement_of(p)
    t = p.detach().cpu()
    if pl is None:
        return t.numpy().copy()
    seen = []
    dist.all_gather_object(seen, (pl.pieces, t), group=MESH.group("mp"))
    out = np.empty(pl.global_shape, np.float32)
    for pieces, local in seen:
        for li, gi in pieces:
            out[tuple(slice(*q) for q in gi)] = \
                local[tuple(slice(*q) for q in li)].numpy()
    return out


class OneProcess:
    def get_pipe_parallel_world_size(self):
        return 2

    def get_stage_id(self):
        return 0

    def get_pipe_parallel_group(self):
        return SimpleNamespace(ranks=[0, 0])


def strategy_for(m):
    s = fleet.get_strategy()
    s.pipeline_configs = {"accumulate_steps": m, "micro_batch_size": 2,
                          "schedule_mode": "1F1B"}
    return s


def run(tag, rows, m, level=None):
    # two steps of the pipeline over `rows` of each batch in `m`
    # microbatches, held to one process's _local_train on the whole batch
    # in 4 (the ranks' own when no data axis splits it)
    stage = MESH.coord["pp"]

    def batches(sel):
        return [(torch.from_numpy(W[f"x{i}"][sel]),
                 torch.from_numpy(W[f"y{i}"][sel])) for i in range(2)]

    strategy_for(m)
    pipe = fleet.distributed_model(build(True))
    assert type(pipe) is PipelineParallel and pipe._multi
    inner = SGD(learning_rate=%(lr)r, parameters=pipe.parameters())
    if level is None:
        opt = fleet.distributed_optimizer(inner)
    else:   # ZeRO through group_sharded_parallel, the pipeline driven as is
        _, opt, _ = group_sharded_parallel(pipe, inner, level)
    losses = [float(pipe.train_batch(b, opt)) for b in batches(rows)]
    local = PipelineParallel(build(False), OneProcess(), strategy_for(4))
    lopt = SGD(learning_rate=%(lr)r, parameters=local.parameters())
    want = [float(local.train_batch(b, lopt))
            for b in batches(slice(None))]
    mine = [p for layer, _ in local._layers.get_stage_layers(stage)
            for p in layer.parameters()]
    ids = {id(p) for p in mine}
    mine_names = [n for n, p in local._layers.named_parameters()
                  if id(p) in ids]
    got = {n: gather_mp(p)
           for n, p in zip(mine_names, pipe._layers.parameters())}
    errs = {n: rel_err(got[n], p.detach().numpy())
            for n, p in zip(mine_names, mine)}
    assert max(errs.values()) <= %(tol)r, (tag, errs, losses, want)
    np.savez(f"{DATA}/{tag}_r{RANK}.npz", losses=np.array(losses),
             local_losses=np.array(want),
             **{f"p/{n}": v for n, v in got.items()})
    ok(tag)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


run("mp", slice(None), 4)
strategy = fleet.DistributedStrategy()
strategy.hybrid_configs = {"dp_degree": 1, "pp_degree": 2,
                           "sharding_degree": 2, "mp_degree": 1}
fleet.init(is_collective=True, strategy=strategy)
MESH = get_default_mesh()
half = MESH.coord["sharding"]
run("zero", slice(4 * half, 4 * half + 4), 2)
run("zero2", slice(4 * half, 4 * half + 4), 2, "os_g")
""" % {"lr": LR, "tol": TOL}


def _jax_pipeline(mesh_mp):
    """The reference's pipeline with its mp layers (on an mp-2 mesh of the
    session's virtual devices when ``mesh_mp``), its weights and two
    batches; returns (model, SGD, numpy state, data)."""
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet import meta_parallel as jmp
    from paddle_tpu.distributed.sharding_api import (build_mesh,
                                                     set_default_mesh)
    if mesh_mp:
        set_default_mesh(build_mesh(dp=1, mp=2, devices=jax.devices()[:2]))
    paddle.seed(0)
    descs = []
    for _ in range(2):
        descs += [jmp.LayerDesc(jmp.ColumnParallelLinear, 8, 16,
                                gather_output=False),
                  jmp.LayerDesc(paddle.nn.Tanh),
                  jmp.LayerDesc(jmp.RowParallelLinear, 16, 8,
                                input_is_parallel=True)]

    def mse(o, y):
        return ((o - y) * (o - y)).mean()

    model = jmp.PipelineLayer(descs, num_stages=2, loss_fn=mse)
    rng = np.random.default_rng(3)
    state = {}
    for k, v in model.state_dict().items():
        state[k] = (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
    model.set_state_dict(state)
    return model, state


def _jax_run(state, rows, m, mesh_mp, data):
    """The reference's ``PipelineParallel`` (one process, ``_local_train``)
    over ``rows`` of each batch, two SGD steps: (losses, parameters)."""
    from types import SimpleNamespace

    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet import meta_parallel as jmp
    from paddle_tpu.distributed.sharding_api import set_default_mesh

    class Hcg:
        def get_pipe_parallel_world_size(self):
            return 2

        def get_stage_id(self):
            return 0

        def get_pipe_parallel_group(self):
            return SimpleNamespace(ranks=[0, 1])

    try:
        model, _ = _jax_pipeline(mesh_mp)
        model.set_state_dict(state)
        pipe = jmp.PipelineParallel(model, Hcg(), SimpleNamespace(
            pipeline_configs={"accumulate_steps": m, "micro_batch_size": 2,
                              "schedule_mode": "1F1B"}))
        opt = paddle.optimizer.SGD(learning_rate=LR,
                                   parameters=pipe.parameters())
        losses = [float(pipe.train_batch(
            (paddle.to_tensor(data[f"x{i}"][rows]),
             paddle.to_tensor(data[f"y{i}"][rows])), opt))
            for i in range(2)]
        params = {k: np.asarray(v._value)
                  for k, v in model.state_dict().items()}
    finally:
        set_default_mesh(None)
    return losses, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_mp")
    _, state = _jax_pipeline(False)
    rng = np.random.default_rng(4)
    data = {f"{k}{i}": rng.standard_normal((8, 8)).astype(np.float32)
            for i in range(2) for k in ("x", "y")}
    np.savez(tmp / "inputs.npz", **{f"w/{k}": v for k, v in state.items()},
             **data)
    logs = run_ranks(tmp, _WORKER, {"dp_degree": 1, "pp_degree": 2,
                                    "mp_degree": 2}, nproc=4)
    return tmp, logs, state, data


def _gathered(tmp, tag, ranks_):
    """The stage parameters the ranks saved (whole, by global name) and
    each rank's losses."""
    params, losses = {}, {}
    for r in ranks_:
        f = np.load(tmp / f"{tag}_r{r}.npz")
        losses[r] = f["losses"]
        params.update({k[2:]: f[k] for k in f.files if k.startswith("p/")})
    return params, losses


def test_pipeline_with_mp_layers_matches_one_process_and_reference(ranks):
    tmp, logs, state, data = ranks
    assert_check(logs, "mp", nproc=4)
    params, losses = _gathered(tmp, "mp", range(4))
    local = np.load(tmp / "mp_r0.npz")["local_losses"]
    jlosses, jparams = _jax_run(state, slice(None), 4, True, data)
    assert set(params) == set(jparams)
    assert rel_err(local, jlosses) <= TOL, (local, jlosses)
    for r in range(4):
        assert rel_err(losses[r], jlosses) <= TOL, (r, losses[r], jlosses)
    for k, v in jparams.items():
        assert rel_err(params[k], v) <= TOL, k


@pytest.mark.parametrize("tag", ["zero", "zero2"])
def test_pipeline_under_zero_averages_over_sharding_once(ranks, tag):
    tmp, logs, state, data = ranks
    assert_check(logs, tag, nproc=4)
    params, losses = _gathered(tmp, tag, range(4))
    jlosses, jparams = _jax_run(state, slice(None), 4, False, data)
    # rank = 2 pp + sharding: each data rank's loss is over its 4 rows
    mean = (np.asarray(losses[0]) + np.asarray(losses[1])) / 2
    assert rel_err(mean, jlosses) <= TOL, (losses, jlosses)
    for k, v in jparams.items():
        assert rel_err(params[k], v) <= TOL, k
