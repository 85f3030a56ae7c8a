"""Context parallelism across the whole hybrid mesh (``text/gpt.py`` under
``tensor_parallel``, ``sequence_parallel`` and ``context_parallel``,
``sharding.group_sharded_parallel``/``sync_gradients``/``hybrid_clip`` with
sep, ``GPTForPretrainingPipe`` on a pp x sep mesh, ``convert.
slice_gpt_state``, ``distributed.checkpoint``) against the JAX package's
eight-device steps.

The reference runs once in a module fixture on the session's 8 virtual CPU
devices: its TP GPT with ``context_parallel`` "ring" and "ulysses" at
``build_mesh(dp=1, sharding=2, sep=2, mp=2)`` (its GPT does not read
``sequence_parallel``: GSPMD places the sequence, so the port's SP model is
held to the same global function), the batch placed ``P(("sharding",),
"sep")``: eager loss and gradients, the clip's scale, an eager AdamW step
(lr 1e-3) and its compiled ZeRO-3 step's loss; and its
``GPTForPretrainingPipe`` at ``build_mesh(dp=1, pp=2, sharding=2, sep=2)``,
the batch over sharding only, the same.

Eight gloo ranks on the CPU run once for the file:

- ``fleet.init`` at sharding 2 x sep 2 x mp 2 (rank = 4·sharding + 2·sep +
  mp), the tiny GPT of ``_torch_hybrid_helpers`` (4 heads, 2 a rank,
  Ulysses' 1 a sep rank) with SP and CP, each data rank on its 2 of the
  4 x 32 rows and each sep rank on its 16 tokens (the labels of 13 of each
  row's first 16 ignored, so the sep ranks hold very different counts), at
  ZeRO ``p_g_os``, ``os`` and ``os_g`` for each mode: the sep and mp ranks
  of a data rank report bit-equal losses, whose data-rank mean is within
  ``TOL`` of the reference's eager and compiled losses; the synced
  gradients and AdamW-updated parameters, gathered whole, within 1e-5 of
  each tensor's largest entry (parameters by ``param_rule_err``'s rule);
  ``hybrid_clip``'s scale against the reference's; each placed piece
  bit-equal to ``convert.slice_gpt_state`` at the rank's (mp, sharding);
  the ring ``p_g_os`` model saved through ``distributed.checkpoint`` from
  the mesh (the ranks at sep 1 write no tensor), loaded back into the mesh
  bit-equal and whole in this process;
- ``fleet.init`` again at pp 2 x sharding 2 x sep 2 (rank = 4·pp +
  2·sharding + sep): ``GPTForPretrainingPipe`` under ``p_g_os``, every sep
  rank on its data rank's whole 4 x 32 in 4 microbatches: the same holds,
  and the two sep ranks' gradients are bit-equal (no sum over sep);
- in this process: ``HybridCommunicateGroup`` at both meshes, every rank,
  against the reference's.
"""
import json
import os
import pickle

import numpy as np
import pytest

from _torch_hybrid_helpers import (GPT_KW, assert_check, param_rule_err,
                                   rel_err, run_ranks, save_npz)

TOL = 1e-5
MODES = ("ring", "ulysses")
LEVELS = ("p_g_os", "os", "os_g")
CASES = tuple((m, lv) for m in MODES for lv in LEVELS)
HYBRID = {"sharding_degree": 2, "sep_degree": 2, "mp_degree": 2}
# the pipe GPT: 4 layers, hidden 32, 2 heads, vocab 64, sequence 32
PKW = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=2,
           intermediate_size=64, max_seq_len=32, dropout=0.0)
# (dp, pp, sharding, sep, mp) of the two meshes
DIMS = {"cp": (1, 1, 2, 2, 2), "pipe": (1, 2, 2, 2, 1)}


def _batch():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, (4, 32)).astype(np.int64)
    labels = rng.integers(0, 128, (4, 32)).astype(np.int64)
    labels[:, :13] = -100          # sep rank 0 keeps 3 of its 16 a row
    return ids, labels


def _pipe_batch():
    rng = np.random.default_rng(6)
    return (rng.integers(0, 64, (8, 32)).astype(np.int64),
            rng.integers(0, 64, (8, 32)).astype(np.int64))


def _np_state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("rank", range(8))
@pytest.mark.parametrize("mesh", sorted(DIMS))
def test_topology_matches_the_reference(mesh, rank):
    import paddle_tpu.distributed.env as jenv
    from paddle_tpu.distributed.fleet.base.topology import (
        CommunicateTopology as JTopology, HybridCommunicateGroup as JHCG)
    from paddle_tpu_torch.distributed import env as penv
    from paddle_tpu_torch.distributed.fleet.base.topology import (
        CommunicateTopology, HybridCommunicateGroup)
    from paddle_tpu_torch.distributed.sharding_api import (data_rank_world,
                                                           set_default_mesh)
    dims = DIMS[mesh]
    try:
        jenv.set_rank_world_size(rank, 8)
        penv.set_rank_world_size(rank, 8)
        got = HybridCommunicateGroup(CommunicateTopology(dims=dims))
        want = JHCG(JTopology(dims=dims))
        for q in ("data_parallel", "model_parallel", "sharding_parallel",
                  "sep_parallel", "pipe_parallel"):
            assert getattr(got, f"get_{q}_rank")() == \
                getattr(want, f"get_{q}_rank")(), q
            assert getattr(got, f"get_{q}_world_size")() == \
                getattr(want, f"get_{q}_world_size")(), q
            assert getattr(got, f"get_{q}_group")().ranks == \
                getattr(want, f"get_{q}_group")().ranks, q
        if dims[1] > 1:
            assert got.get_pipe_prev_rank() == want.get_pipe_prev_rank()
            assert got.get_pipe_next_rank() == want.get_pipe_next_rank()
        # the sep (and mp, pp) ranks of a data rank see its rows
        assert data_rank_world(got.mesh) == (rank // 2 % 2 if mesh == "pipe"
                                             else rank // 4, 2)
    finally:
        set_default_mesh(None)
        jenv.set_rank_world_size(None, None)
        penv.set_rank_world_size(None, None)


_WORKER = """
from paddle_tpu_torch.convert import (load_jax_state, slice_gpt_state,
                                      slice_pipe_gpt_state)
from paddle_tpu_torch.distributed import checkpoint as dck
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
    group_sharded_parallel, hybrid_clip, state_placement)
from paddle_tpu_torch.distributed.sharding_api import sep_local_batch
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.gpt import (GPTConfig, GPTForPretraining,
                                       GPTForPretrainingPipe)

G = np.load(f"{DATA}/hybrid.npz")
KW, PKW = json.loads(str(G["kw"])), json.loads(str(G["pkw"]))
CASES = json.loads(str(G["cases"]))
STATE = {k.split("/", 1)[1]: G[k] for k in G.files if k.startswith("state/")}
PSTATE = {k.split("/", 1)[1]: G[k] for k in G.files
          if k.startswith("pstate/")}
ids, labels = torch.from_numpy(G["ids"]), torch.from_numpy(G["labels"])
SH, SEP, MP = (MESH.coord[a] for a in ("sharding", "sep", "mp"))
assert RANK == 4 * SH + 2 * SEP + MP, (RANK, MESH)
ROWS = slice(2 * SH, 2 * SH + 2)
out = {}


def build(mode, level, seed=None):
    m = GPTForPretraining(GPTConfig(tensor_parallel=True,
                                    sequence_parallel=True,
                                    context_parallel=mode, **KW),
                          device="cpu", seed=seed or 0)
    if seed is None:
        load_jax_state(m, slice_gpt_state(STATE, 2, MP))
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    wrapped, zopt, _ = group_sharded_parallel(m, opt, level)
    step = CompiledTrainStep(lambda a, b: wrapped(a, labels=b)[1], wrapped,
                             getattr(zopt, "_optim", zopt))
    return m, wrapped, step


def record(key, named, grads):
    for (n, p), g in zip(named, grads):
        out[f"{key}/grad/{n}"] = gather_global(
            g, state_placement(p, g)).numpy()
        out[f"{key}/param/{n}"] = gather_global(p).numpy()
    params = [p for _, p in named]
    clipped = hybrid_clip(ClipGradByGlobalNorm(0.1), params, grads, MESH)
    i = max(range(len(grads)), key=lambda j: float(grads[j].abs().max()))
    flat = grads[i].abs().flatten().argmax()
    out[f"{key}/clip_scale"] = float((clipped[i] / grads[i]).flatten()[flat])


for mode, level in CASES:
    key = f"{mode}/{level}"
    m, wrapped, step = build(mode, level)
    named = list(m.named_parameters())
    # each placed piece is convert's piece at (mp, sharding): sep replicates
    want = slice_gpt_state(STATE, 2, MP, 2 if level == "p_g_os" else 1, SH)
    for n, p in named:
        assert np.array_equal(p.detach().numpy(), want[n]), (key, n)
    real, seen = step._sync, {}
    step._sync = lambda g: seen.setdefault("grads", real(g))
    loss = float(step(sep_local_batch(ids[ROWS]),
                      sep_local_batch(labels[ROWS])))
    losses = []
    dist.all_gather_object(losses, loss)
    # the sep and mp ranks of a data rank hold its global loss
    assert losses[RANK] == losses[RANK ^ 1] == losses[RANK ^ 2], losses
    out[f"{key}/losses"] = np.array(losses)
    record(key, named, seen["grads"])
    if (mode, level) == ("ring", "p_g_os"):
        dck.save_state_dict(wrapped.state_dict(), f"{DATA}/ckpt")
        # back into the mesh: a model of other weights, placed the same
        m2, wrapped2, _ = build(mode, level, seed=1)
        dck.load_state_dict(wrapped2.state_dict(), f"{DATA}/ckpt")
        for (n, a), (_, b) in zip(named, m2.named_parameters()):
            assert torch.equal(a.detach(), b.detach()), n
        ok("checkpoint_mesh")
    ok(key)

# the pipeline on a sep mesh: every sep rank runs the whole sequence
strategy = fleet.DistributedStrategy()
strategy.hybrid_configs = {"pp_degree": 2, "sharding_degree": 2,
                           "sep_degree": 2}
fleet.init(is_collective=True, strategy=strategy)
MESH = get_default_mesh()
PP, SH, SEP = (MESH.coord[a] for a in ("pp", "sharding", "sep"))
assert RANK == 4 * PP + 2 * SH + SEP, (RANK, MESH)
pids, plabels = torch.from_numpy(G["pids"]), torch.from_numpy(G["plabels"])
m = GPTForPretrainingPipe(GPTConfig(**PKW), n_microbatch=4, device="cpu")
load_jax_state(m, slice_pipe_gpt_state(PSTATE, 2, None, 1))
opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
wrapped, zopt, _ = group_sharded_parallel(m, opt, "p_g_os")
step = CompiledTrainStep(lambda a, b: wrapped(a, labels=b)[1], wrapped,
                         getattr(zopt, "_optim", zopt))
named = list(m.named_parameters())
want = slice_pipe_gpt_state(PSTATE, 2, PP, 1, 1, 0, 2, SH)
for n, p in named:
    assert np.array_equal(p.detach().numpy(), want[n]), n
real, seen = step._sync, {}
step._sync = lambda g: seen.setdefault("grads", real(g))
rows = slice(4 * SH, 4 * SH + 4)
loss = float(step(pids[rows], plabels[rows]))
losses = []
dist.all_gather_object(losses, loss)
assert losses[RANK] == losses[RANK ^ 1] == losses[RANK ^ 4], losses
out["pipe/losses"] = np.array(losses)
mine = [g.detach().clone() for g in seen["grads"]]
everyone = []
dist.all_gather_object(everyone, mine)
assert all(torch.equal(a, b) for a, b in zip(mine, everyone[RANK ^ 1]))
ok("pipe_sep_grads_bit_equal")
record("pipe", named, seen["grads"])
ok("pipe")
if RANK == 0:
    np.savez(f"{DATA}/out.npz", **out)
dist.barrier()
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference on its eight-device meshes, from one seed's weights:
    for each mode its eager loss, gradients, clip scale and AdamW step and
    its compiled ZeRO-3 step's loss; the same for the pipe GPT."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel as jzero
    from paddle_tpu.distributed.sharding_api import (build_mesh as jbuild,
                                                     set_default_mesh as jset)
    from paddle_tpu.jit.train_step import CompiledTrainStep as JStep
    from paddle_tpu.text.gpt import (GPTConfig as JC, GPTForPretraining as JG,
                                     GPTForPretrainingPipe as JP)
    prev = os.environ.get("PDTPU_PALLAS_INTERPRET")
    os.environ["PDTPU_PALLAS_INTERPRET"] = "0"
    d = tmp_path_factory.mktemp("context_hybrid")
    ids, labels = _batch()
    pids, plabels = _pipe_batch()
    ref = {}

    def one(make, spec_mesh, spec, batch):
        """(state, eager results, compiled ZeRO-3 loss) of ``make()``."""
        sh = NamedSharding(spec_mesh, spec)
        placed = [paddle.Tensor(jax.device_put(jnp.asarray(a), sh))
                  for a in batch]
        paddle.seed(0)
        jm = make()
        state = _np_state(jm)
        _, loss = jm(placed[0], labels=placed[1])
        loss.backward()
        pg = [(p, p.grad) for p in jm.parameters()]
        clipped = paddle.nn.ClipGradByGlobalNorm(0.1)(pg)
        g0, c0 = (np.asarray(t._value) for t in (pg[0][1], clipped[0][1]))
        flat = np.abs(g0).argmax()
        res = {"loss": float(np.asarray(loss._value)),
               "grads": {n: np.asarray(p.grad._value)
                         for n, p in jm.named_parameters()},
               "clip_scale": float(c0.flat[flat] / g0.flat[flat])}
        paddle.optimizer.AdamW(learning_rate=1e-3,
                               parameters=jm.parameters()).step()
        res["params"] = _np_state(jm)
        paddle.seed(0)
        jm = make()
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=jm.parameters())
        jm, opt, _ = jzero(jm, opt, level="p_g_os")
        step = JStep(lambda i, lb, jm=jm: jm(i, labels=lb)[1], jm,
                     getattr(opt, "_optim", opt), donate=False)
        res["compiled_loss"] = float(np.asarray(step(*placed)._value))
        return state, res

    try:
        mesh = jset(jbuild(dp=1, sharding=2, sep=2, mp=2,
                           devices=jax.devices()[:8]))
        states = {}
        for mode in MODES:
            states[mode], ref[mode] = one(
                lambda mode=mode: JG(JC(tensor_parallel=True,
                                        context_parallel=mode, **GPT_KW)),
                mesh, P(("sharding",), "sep"), (ids, labels))
        assert all(np.array_equal(states["ring"][k], v)
                   for k, v in states["ulysses"].items())
        mesh = jset(jbuild(dp=1, pp=2, sharding=2, sep=2, mp=1,
                           devices=jax.devices()[:8]))
        pstate, ref["pipe"] = one(lambda: JP(JC(**PKW), n_microbatch=4),
                                  mesh, P(("sharding",), None),
                                  (pids, plabels))
    finally:
        jset(jbuild(dp=8))
        if prev is None:
            os.environ.pop("PDTPU_PALLAS_INTERPRET", None)
        else:
            os.environ["PDTPU_PALLAS_INTERPRET"] = prev
    save_npz(d / "hybrid.npz", ids=ids, labels=labels, pids=pids,
             plabels=plabels, kw=np.array(json.dumps(GPT_KW)),
             pkw=np.array(json.dumps(PKW)),
             cases=np.array(json.dumps(CASES)),
             **{f"state/{n}": v for n, v in states["ring"].items()},
             **{f"pstate/{n}": v for n, v in pstate.items()})
    return d, ref


@pytest.fixture(scope="module")
def ranks(reference):
    d, _ = reference
    logs = run_ranks(d, _WORKER, HYBRID, nproc=8, timeout=400)
    return logs, dict(np.load(d / "out.npz"))


def _held(ref, out, key, data_loss):
    assert abs(data_loss - ref["loss"]) <= TOL * abs(ref["loss"])
    assert abs(data_loss - ref["compiled_loss"]) <= \
        TOL * abs(ref["compiled_loss"])
    for name, g_want in ref["grads"].items():
        g = out[f"{key}/grad/{name}"]
        assert g.shape == g_want.shape, name
        assert rel_err(g, g_want) <= TOL, (key, name, rel_err(g, g_want))
        err = param_rule_err(out[f"{key}/param/{name}"],
                             ref["params"][name], g, g_want)
        assert err <= TOL, (key, name, err)
    want = ref["clip_scale"]
    assert abs(float(out[f"{key}/clip_scale"]) - want) <= TOL * want


@pytest.mark.parametrize("mode,level", CASES)
def test_sp_cp_step_matches_the_eight_device_reference(reference, ranks,
                                                       mode, level):
    """SP and CP at sharding 2 x sep 2 x mp 2 under ZeRO ``level``: the
    data ranks' mean loss, the synced gradients, the updated parameters
    and the clip's scale against the reference's TP + CP step."""
    _, ref = reference
    logs, out = ranks
    key = f"{mode}/{level}"
    assert_check(logs, key, nproc=8)
    losses = out[f"{key}/losses"]
    # rank = 4 sharding + 2 sep + mp: the data rank is the sharding index
    _held(ref[mode], out, key, (losses[0] + losses[4]) / 2)


def test_pipe_on_a_sep_mesh_matches_the_reference(reference, ranks):
    """``GPTForPretrainingPipe`` at pp 2 x sharding 2 x sep 2 under
    ``p_g_os``: every sep rank runs the whole sequence, the two sep ranks'
    gradients are bit-equal (the ranks assert it), and the step is the
    reference's."""
    _, ref = reference
    logs, out = ranks
    assert_check(logs, "pipe_sep_grads_bit_equal", nproc=8)
    assert_check(logs, "pipe", nproc=8)
    losses = out["pipe/losses"]
    # rank = 4 pp + 2 sharding + sep
    _held(ref["pipe"], out, "pipe", (losses[0] + losses[2]) / 2)


def test_mesh_checkpoint_loads_back_and_whole(reference, ranks):
    """The ring ``p_g_os`` model's checkpoint from the mesh: loaded back
    into the mesh bit-equal (the ranks assert it), loaded whole here
    bit-equal to the gathered parameters, and written once per sep
    replica: the ranks at sep coordinate 1 hold no tensor."""
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.distributed.sharding_api import set_default_mesh
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    d, _ = reference
    logs, out = ranks
    assert_check(logs, "checkpoint_mesh", nproc=8)
    for r in range(8):
        with open(d / "ckpt" / f"shard_{r}.pkl", "rb") as f:
            shards = pickle.load(f)
        assert bool(shards) == (r // 2 % 2 == 0), (r, sorted(shards))
    set_default_mesh(None)
    m = GPTForPretraining(GPTConfig(**GPT_KW), device="cpu", seed=1)
    dck.load_state_dict(m.state_dict(), str(d / "ckpt"))
    for n, p in m.named_parameters():
        assert np.array_equal(p.detach().numpy(),
                              out[f"ring/p_g_os/param/{n}"]), n
