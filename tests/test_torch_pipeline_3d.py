"""Tensor parallelism and ZeRO inside the port's SPMD pipeline
(``text/gpt.py`` ``StackedGPTBlocks(tensor_parallel=True)`` and
``GPTForPretrainingPipe``, ``spmd_pipeline(param_specs=)``,
``sharding.group_sharded_parallel``/``sync_gradients``/``hybrid_clip``,
``CompiledTrainStep``, ``convert.slice_pipe_gpt_state``,
``distributed.checkpoint``) against the JAX package's eight-device step.

The reference runs once in a module fixture on the session's 8 virtual
CPU devices, ``build_mesh(dp=1, pp=2, sharding=2, sep=1, mp=2)`` with
``tensor_parallel=True`` (as ``tests/test_multichip_scaled.py:246`` runs
it): for GPipe and for interleaved with remat, its eager gradients on that
mesh, its eager AdamW step (lr 1e-3) and its compiled ZeRO-3 step's loss.

Eight gloo ranks on the CPU run once for the file, ``fleet.init`` at pp 2
x sharding 2 x mp 2 (rank = 4·pp + 2·sharding + mp), each data rank on
its half of an 8 x 32 batch in 4 microbatches, from the reference's
weights (whole, then placed by ``group_sharded_parallel``):

- the loss of each case at ``p_g_os``, and at ``os`` and ``os_g`` for
  GPipe: the eight ranks' losses equal, their data ranks' mean within
  ``TOL`` 1e-5 (relative) of the reference's eager and compiled losses;
- the synced gradients and the AdamW-updated parameters, gathered whole,
  within 1e-5 of each tensor's largest entry of the reference's (the
  parameters by ``param_rule_err``'s first-step rule);
- ``hybrid_clip``'s scale against the reference's ``ClipGradByGlobalNorm``
  on its gradients, and ``ClipGradByNorm``'s per-tensor scale against each
  whole reference gradient's norm (1e-5);
- each placed piece bit-equal to ``convert.slice_pipe_gpt_state`` at the
  rank's (pp, sharding, mp), an mp pair's replicated leaves bit-equal, and
  the parameter + AdamW bytes a rank equal to the sum of the placements'
  pieces and to the count the placements predict;
- the O2 bf16 step per call and in ``run_steps``, and a checkpoint of the
  mesh loaded back into the mesh bit-equal and whole in this process;
- the topology's answers against the reference's, and ``tensor_parallel``
  warning once on a mesh without pp or mp.
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_hybrid_helpers import (assert_check, param_rule_err, rel_err,
                                   run_ranks, save_npz)
from paddle_tpu_torch.distributed.fleet.meta_parallel import spmd_pipeline \
    as tsp
from paddle_tpu_torch.distributed.sharding_api import Mesh, set_default_mesh
from paddle_tpu_torch.text.gpt import (GPTConfig, GPTForPretrainingPipe,
                                       StackedGPTBlocks)

TOL = 1e-5
KW = dict(vocab_size=64, hidden_size=32, num_layers=8, num_heads=2,
          intermediate_size=64, max_seq_len=32, dropout=0.0)
DIMS = (1, 2, 2, 1, 2)
# (case, n_chunks, remat, ZeRO level)
CASES = (("gpipe", 1, False, "p_g_os"), ("interleaved", 2, True, "p_g_os"),
         ("gpipe_os", 1, False, "os"), ("gpipe_os_g", 1, False, "os_g"))


def _batch():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 64, (8, 32)).astype(np.int64),
            rng.integers(0, 64, (8, 32)).astype(np.int64))


def _np_state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def _natural(nc, name, arr):
    """A stacked tensor stored chunk-major back in natural layer order."""
    if name.startswith("blocks.") and nc > 1:
        return arr[np.argsort(tsp.interleave_row_order(8, 2, nc))]
    return arr


def test_tensor_parallel_warns_once_without_pp_or_mp(recwarn):
    """pp alone (the placements keep no mp range) and mp alone (the
    sequential loop runs): one warning each, as in the reference."""
    x = torch.zeros(2, 32, 32)
    try:
        for dims, run in (((1, 2, 1, 1, 1), "commit"), ((1, 1, 1, 1, 2),
                                                        "forward")):
            set_default_mesh(Mesh(dims, rank=0))
            blocks = StackedGPTBlocks(GPTConfig(tensor_parallel=True, **KW),
                                      device="cpu")
            for _ in range(2):
                if run == "commit":
                    blocks._stage = None
                    blocks.commit_param_shardings()
                else:
                    blocks(x)
            if run == "commit":
                assert all(p._placement.axes == ("pp",)
                           for p in blocks._params())
            pp, mp = dims[1], dims[4]
            said = [w for w in recwarn if f"(pp={pp}, mp={mp})" in
                    str(w.message)]
            assert len(said) == 1, [str(w.message) for w in recwarn]
    finally:
        set_default_mesh(None)


@pytest.mark.parametrize("rank", range(8))
def test_topology_at_pp2_sharding2_mp2_matches_reference(rank):
    import paddle_tpu.distributed.env as jenv
    from paddle_tpu.distributed.fleet.base.topology import (
        CommunicateTopology as JTopology, HybridCommunicateGroup as JHCG)
    from paddle_tpu_torch.distributed import env as penv
    from paddle_tpu_torch.distributed.fleet.base.topology import (
        CommunicateTopology, HybridCommunicateGroup)
    from paddle_tpu_torch.distributed.sharding_api import data_rank_world
    try:
        jenv.set_rank_world_size(rank, 8)
        penv.set_rank_world_size(rank, 8)
        got = HybridCommunicateGroup(CommunicateTopology(dims=DIMS))
        want = JHCG(JTopology(dims=DIMS))
        for q in ("data_parallel", "model_parallel", "sharding_parallel",
                  "sep_parallel", "pipe_parallel"):
            assert getattr(got, f"get_{q}_rank")() == \
                getattr(want, f"get_{q}_rank")(), q
            assert getattr(got, f"get_{q}_world_size")() == \
                getattr(want, f"get_{q}_world_size")(), q
            assert getattr(got, f"get_{q}_group")().ranks == \
                getattr(want, f"get_{q}_group")().ranks, q
        assert got.get_pipe_prev_rank() == want.get_pipe_prev_rank()
        assert got.get_pipe_next_rank() == want.get_pipe_next_rank()
        # the mp and pp ranks of a data rank see its rows
        assert data_rank_world(got.mesh) == (rank // 2 % 2, 2)
    finally:
        set_default_mesh(None)
        jenv.set_rank_world_size(None, None)
        penv.set_rank_world_size(None, None)


# -- eight gloo ranks: pp 2 x sharding 2 x mp 2 -------------------------------
_WORKER = """
from paddle_tpu_torch.convert import load_jax_state, slice_pipe_gpt_state
from paddle_tpu_torch.distributed import checkpoint as dck
from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
    group_sharded_parallel, hybrid_clip, state_bytes, state_placement)
from paddle_tpu_torch.distributed.sharding_api import data_rank_world
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm, ClipGradByNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretrainingPipe

G = np.load(f"{DATA}/pipe3d.npz")
KW = json.loads(str(G["kw"]))
CASES = json.loads(str(G["cases"]))
STATE = {k.split("/", 1)[1]: G[k] for k in G.files
         if k.startswith("state/")}
ids, labels = torch.from_numpy(G["ids"]), torch.from_numpy(G["labels"])
PP, SH, MP = (MESH.coord[a] for a in ("pp", "sharding", "mp"))
assert MESH.shape["pp"] == MESH.shape["sharding"] == MESH.shape["mp"] == 2
assert RANK == 4 * PP + 2 * SH + MP
hcg = fleet.get_hybrid_communicate_group()
print(json.dumps({"topology": {q: [getattr(hcg, f"get_{q}_rank")(),
                                   getattr(hcg, f"get_{q}_world_size")()]
                               for q in ("data_parallel", "model_parallel",
                                         "sharding_parallel",
                                         "pipe_parallel")}}), flush=True)
assert data_rank_world() == (SH, 2)
ROWS = slice(4 * SH, 4 * SH + 4)
out = {}


def build(nc, remat, level, amp="O0", seed=None):
    m = GPTForPretrainingPipe(GPTConfig(tensor_parallel=True, **KW),
                              n_microbatch=4, n_chunks=nc, remat=remat,
                              device="cpu", seed=seed or 0)
    if seed is None:
        load_jax_state(m, slice_pipe_gpt_state(STATE, 2, None, nc))
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    wrapped, zopt, _ = group_sharded_parallel(m, opt, level)
    step = CompiledTrainStep(lambda a, b: wrapped(a, labels=b)[1], wrapped,
                             getattr(zopt, "_optim", zopt), amp_level=amp)
    return m, wrapped, opt, step


def pieces(pl, t):
    if pl is None:
        return t.numel()
    return sum(int(np.prod([b - a for a, b in li])) for li, _ in pl.pieces)


for case, nc, remat, level in CASES:
    m, wrapped, opt, step = build(nc, remat, level)
    named = list(m.named_parameters())
    # each placed piece is convert's piece of the reference's state
    want = slice_pipe_gpt_state(STATE, 2, PP, nc, 2, MP,
                                2 if level == "p_g_os" else 1, SH)
    for n, p in named:
        assert np.array_equal(p.detach().numpy(), want[n]), (case, n)
    real, seen = step._sync, {}
    step._sync = lambda g: seen.setdefault("grads", real(g))
    mp_layers.comm_meter(on=True, reset=True)
    loss = float(step(ids[ROWS], labels[ROWS]))
    meter = mp_layers.comm_meter(on=False)
    losses = []
    dist.all_gather_object(losses, loss)
    assert len(set(losses)) == 2, losses     # one loss a data rank
    assert losses[RANK] == losses[RANK ^ 1] == losses[RANK ^ 4]
    out[f"{case}/losses"] = np.array(losses)
    params = [p for _, p in named]
    grads = seen["grads"]
    for (n, p), g in zip(named, grads):
        out[f"{case}/grad/{n}"] = gather_global(
            g, state_placement(p, g)).numpy()
        out[f"{case}/param/{n}"] = gather_global(p).numpy()
    # an mp pair's replicated leaves are bit-equal
    mine = {n: p.detach().clone() for n, p in named
            if placement_of(p) is None or "mp" not in placement_of(p).axes}
    everyone = []
    dist.all_gather_object(everyone, mine)
    for n, t in mine.items():
        assert torch.equal(t, everyone[RANK ^ 1][n]), (case, n)
    clipped = hybrid_clip(ClipGradByGlobalNorm(0.1), params, grads, MESH)
    i = max(range(len(grads)), key=lambda j: float(grads[j].abs().max()))
    flat = grads[i].abs().flatten().argmax()
    out[f"{case}/clip_scale"] = float((clipped[i] / grads[i]).flatten()[flat])
    # ClipGradByNorm: each gradient by the norm of its whole gradient
    by_norm = hybrid_clip(ClipGradByNorm(0.05), params, grads, MESH)
    out[f"{case}/by_norm_scale"] = np.array([
        float((c / g).flatten()[g.abs().flatten().argmax()])
        for c, g in zip(by_norm, grads)])
    pb, ob = state_bytes(opt, params)
    placed = sum(pieces(placement_of(p), p) * p.element_size()
                 for p in params)
    accs = [v for p in params for v in opt._accumulators[id(p)].values()
            if torch.is_tensor(v)]
    placed_state = sum(pieces(placement_of(v), v) * v.element_size()
                       for v in accs)
    assert (pb, ob) == (placed, placed_state), (pb, ob, placed, placed_state)
    counts = []
    dist.all_gather_object(counts, [p.numel() for p in params])
    out[f"{case}/param_elements"] = np.array([sum(c) for c in counts])
    out[f"{case}/state_bytes"] = np.array([pb, ob])
    out[f"{case}/mp_meter"] = np.array([meter["calls"], meter["bytes"]])
    if case == "gpipe":
        dck.save_state_dict(wrapped.state_dict(), f"{DATA}/ckpt")
        # back into the mesh: a model of other weights, placed the same
        m2, wrapped2, _, _ = build(nc, remat, level, seed=1)
        dck.load_state_dict(wrapped2.state_dict(), f"{DATA}/ckpt")
        for (n, a), (_, b) in zip(named, m2.named_parameters()):
            assert torch.equal(a.detach(), b.detach()), n
        ok("checkpoint_mesh")
    ok(case)

# O2 bf16: one call, then run_steps from the same weights
losses = {}
for how in ("call", "run_steps"):
    m, wrapped, opt, step = build(1, False, "p_g_os", amp="O2")
    if how == "call":
        losses[how] = [float(step(ids[ROWS], labels[ROWS])) for _ in range(2)]
    else:
        k = lambda t: t[ROWS][None].repeat(2, 1, 1)
        losses[how] = [float(v) for v in step.run_steps(k(ids), k(labels))]
assert losses["call"] == losses["run_steps"], losses
assert all(np.isfinite(losses["call"])) and \\
    losses["call"][1] < losses["call"][0], losses
out["o2/losses"] = np.array(losses["call"])
ok("o2")
if RANK == 0:
    np.savez(f"{DATA}/out.npz", **out)
dist.barrier()
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference on its eight-device mesh: for each chunking, its
    eager gradients, its eager AdamW step and its compiled ZeRO-3 step's
    loss, from one seed's weights (natural layer order)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.meta_parallel.sharding import \
        group_sharded_parallel as jzero
    from paddle_tpu.distributed.sharding_api import (build_mesh as jbuild,
                                                     set_default_mesh as jset)
    from paddle_tpu.jit.train_step import CompiledTrainStep as JStep
    from paddle_tpu.text.gpt import GPTConfig as JC, \
        GPTForPretrainingPipe as JP
    prev = os.environ.get("PDTPU_PALLAS_INTERPRET")
    os.environ["PDTPU_PALLAS_INTERPRET"] = "0"
    d = tmp_path_factory.mktemp("pipeline_3d")
    ids, labels = _batch()
    ref = {}
    try:
        mesh = jbuild(dp=1, pp=2, sharding=2, sep=1, mp=2,
                      devices=jax.devices()[:8])
        sh = NamedSharding(mesh, P(("sharding",), None))

        def batch():
            return (paddle.Tensor(jax.device_put(ids, sh)),
                    paddle.Tensor(jax.device_put(labels, sh)))

        for case, nc, remat in (("gpipe", 1, False),
                                ("interleaved", 2, True)):
            jset(mesh)
            paddle.seed(0)
            jm = JP(JC(tensor_parallel=True, **KW), n_microbatch=4,
                    n_chunks=nc, remat=remat)
            state = {k: _natural(nc, k, v) for k, v in _np_state(jm).items()}
            if nc == 1:
                ref["state"] = state
            # one seed's weights: the chunked model stores them chunk-major
            assert all(np.array_equal(v, ref["state"][k])
                       for k, v in state.items())
            ids_t, labels_t = batch()
            _, loss = jm(ids_t, labels=labels_t)
            loss.backward()
            pg = [(p, p.grad) for p in jm.parameters()]
            clipped = paddle.nn.ClipGradByGlobalNorm(0.1)(pg)
            g0, c0 = (np.asarray(t._value) for t in (pg[0][1],
                                                     clipped[0][1]))
            flat = np.abs(g0).argmax()
            ref[case] = {
                "loss": float(np.asarray(loss._value)),
                "grads": {n: _natural(nc, n, np.asarray(p.grad._value))
                          for n, p in jm.named_parameters()},
                "clip_scale": float(c0.flat[flat] / g0.flat[flat])}
            paddle.optimizer.AdamW(learning_rate=1e-3,
                                   parameters=jm.parameters()).step()
            ref[case]["params"] = {k: _natural(nc, k, v)
                                   for k, v in _np_state(jm).items()}
            paddle.seed(0)
            jm = JP(JC(tensor_parallel=True, **KW), n_microbatch=4,
                    n_chunks=nc, remat=remat)
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=jm.parameters())
            jm, opt, _ = jzero(jm, opt, level="p_g_os")
            step = JStep(lambda i, lb, jm=jm: jm(i, labels=lb)[1], jm,
                         getattr(opt, "_optim", opt), donate=False)
            ref[case]["compiled_loss"] = float(np.asarray(
                step(*batch())._value))
    finally:
        jset(jbuild(dp=8))
        if prev is None:
            os.environ.pop("PDTPU_PALLAS_INTERPRET", None)
        else:
            os.environ["PDTPU_PALLAS_INTERPRET"] = prev
    save_npz(d / "pipe3d.npz", ids=ids, labels=labels,
             kw=np.array(json.dumps(KW)), cases=np.array(json.dumps(CASES)),
             **{f"state/{n}": v for n, v in ref["state"].items()})
    return d, ref


@pytest.fixture(scope="module")
def ranks(reference):
    d, _ = reference
    logs = run_ranks(d, _WORKER, {"pp_degree": 2, "sharding_degree": 2,
                                  "mp_degree": 2}, nproc=8, timeout=400)
    return logs, dict(np.load(d / "out.npz"))


def _ref_case(case):
    return "interleaved" if case == "interleaved" else "gpipe"


def _nc(case):
    return dict((c[0], c[1]) for c in CASES)[case]


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_loss_matches_the_eight_device_reference(reference, ranks, case):
    _, ref = reference
    logs, out = ranks
    assert_check(logs, case, nproc=8)
    losses = out[f"{case}/losses"]
    # rank = 4 pp + 2 sharding + mp: the data rank is the sharding index
    loss = (losses[0] + losses[2]) / 2
    want = ref[_ref_case(case)]
    assert abs(loss - want["loss"]) <= TOL * abs(want["loss"])
    assert abs(loss - want["compiled_loss"]) <= \
        TOL * abs(want["compiled_loss"])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_gradients_and_update_match_the_reference(reference, ranks, case):
    _, ref = reference
    _, out = ranks
    want = ref[_ref_case(case)]
    for name, g_want in want["grads"].items():
        g = _natural(_nc(case), name, out[f"{case}/grad/{name}"])
        assert rel_err(g, g_want) <= TOL, (case, name)
        p = _natural(_nc(case), name, out[f"{case}/param/{name}"])
        assert param_rule_err(p, want["params"][name], g, g_want) <= TOL, \
            (case, name)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_hybrid_clip_matches_the_reference_clip(reference, ranks, case):
    _, ref = reference
    _, out = ranks
    want = ref[_ref_case(case)]["clip_scale"]
    assert abs(float(out[f"{case}/clip_scale"]) - want) <= TOL * want


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_clip_by_norm_takes_each_whole_gradient(reference, ranks, case):
    """``ClipGradByNorm`` scales each gradient by the norm of its whole
    logical gradient: a stacked leaf's over pp, mp and sharding."""
    _, ref = reference
    _, out = ranks
    grads = ref[_ref_case(case)]["grads"]
    got = out[f"{case}/by_norm_scale"]
    for (name, g), scale in zip(grads.items(), got):
        norm = float(np.sqrt(np.sum(np.square(g.astype(np.float64)))))
        want = min(0.05 / max(norm, 1e-12), 1.0)
        assert abs(scale - want) <= TOL * want, (name, scale, want)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_bytes_a_rank_are_the_placed_pieces(ranks, case):
    """Each rank's parameter elements are what the placements predict:
    a stage's rows (L/pp), their mp pieces for the split leaves, and at
    ``p_g_os`` ZeRO's rows of every leaf and of the embeddings; AdamW's two
    moments are ZeRO's rows of each piece at every level, beside each
    parameter's two scalar beta powers (the bytes equal to the sum of the
    placements' pieces is asserted on every rank)."""
    logs, out = ranks
    assert_check(logs, case, nproc=8)
    L, H, FF = KW["num_layers"], KW["hidden_size"], \
        KW["intermediate_size"]
    V, S = KW["vocab_size"], KW["max_seq_len"]
    split = 3 * H * H + 3 * H + H * H + H * FF + FF + FF * H
    layer = split // 2 + 6 * H
    outside = V * H + S * H + 2 * H
    zero = 2 if case in ("gpipe", "interleaved") else 1
    per_rank = (L // 2 * layer + outside) // zero
    assert list(out[f"{case}/param_elements"]) == [per_rank] * 8
    pb, ob = out[f"{case}/state_bytes"]
    assert pb == per_rank * 4
    # and the 16 parameters' two fp32 beta powers
    assert ob == 2 * 4 * (L // 2 * layer + outside) // 2 + 16 * 2 * 4


def test_mp_sums_are_metered_inside_the_tick_loop(ranks):
    """GPipe: 2 mp all-reduces a layer in each tick's forward and 2 in its
    backward (the column inputs' gradients), 4 layers a stage and 4
    microbatches; each moves one microbatch's [1, 32, 32] fp32 state.
    Interleaved with remat runs each chunk's forward again: 6 a layer."""
    _, out = ranks
    state = 32 * 32 * 4
    assert list(out["gpipe/mp_meter"]) == [4 * 4 * 4, 4 * 4 * 4 * state]
    assert list(out["interleaved/mp_meter"]) == [6 * 4 * 4,
                                                 6 * 4 * 4 * state]


def test_o2_bf16_step_per_call_and_in_run_steps(ranks):
    logs, out = ranks
    assert_check(logs, "o2", nproc=8)
    first, second = out["o2/losses"]
    assert np.isfinite(first) and second < first


def test_mesh_checkpoint_loads_back_and_whole(reference, ranks):
    from paddle_tpu_torch.distributed import checkpoint as dck
    d, _ = reference
    logs, out = ranks
    assert_check(logs, "checkpoint_mesh", nproc=8)
    set_default_mesh(None)
    m = GPTForPretrainingPipe(GPTConfig(**KW), device="cpu", seed=1)
    dck.load_state_dict(m.state_dict(), str(d / "ckpt"))
    for n, p in m.named_parameters():
        assert np.array_equal(p.detach().numpy(), out[f"gpipe/param/{n}"]), n


def test_topology_the_ranks_report(ranks):
    logs, _ = ranks
    for r in range(8):
        line = next(json.loads(x) for x in logs[f"workerlog.{r}"].splitlines()
                    if x.startswith('{"topology"'))["topology"]
        assert line == {"data_parallel": [0, 1], "model_parallel": [r % 2, 2],
                        "sharding_parallel": [r // 2 % 2, 2],
                        "pipe_parallel": [r // 4, 2]}
