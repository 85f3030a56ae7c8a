"""The port's SPMD pipeline (``fleet/meta_parallel/spmd_pipeline.py``),
``StackedGPTBlocks`` and ``GPTForPretrainingPipe`` (``text/gpt.py``) and
their step (``CompiledTrainStep``'s commit, ``sharding.sync_gradients``'s
sum over pp, ``hybrid_clip``) against the JAX package's.

In one process:

- ``pipeline_ticks``, ``bubble_fraction`` and ``interleave_row_order``
  equal the reference's over a grid, with the same error;
- ``GPTForPretrainingPipe`` without a pp axis, tied and untied, with
  LayerNorm and RMSNorm, on the reference's weights (``convert.
  slice_pipe_gpt_state``): logits, loss and every gradient within 1e-5
  of the largest entry (fp32); the sequential loop of a model stored
  chunk-major equals the natural one; dropout and the pipeline's shape
  checks raise; ``tensor_parallel`` warns once where the mesh cannot
  honour it, and inside the pipeline (a pp 2 x mp 2 layout) commits each
  stacked leaf to the reference's ``_tp_param_specs`` axes; the pipeline
  with sep builds and ZeRO with sep syncs (their steps:
  ``tests/test_torch_context_hybrid.py``), while ``Model`` over a
  ``PipelineParallel`` raises naming A7 (ZeRO with the pipeline runs:
  ``tests/test_torch_pipeline_3d.py``).

Across four gloo ranks on the CPU (launched once for the file,
``fleet.init`` at dp 2 x pp 2, each data rank on half of an 8 x 32
batch, 4 microbatches):

- the explicit-rank pipeline of a tanh block (8 layers, both chunkings):
  output and gradients against a sequential loop, 1e-6;
- the eager ``PipelineParallel`` with each stage's gradients averaged over
  dp, against ``_local_train`` on the whole batch, 1e-6;
- ``GPTForPretrainingPipe`` through ``CompiledTrainStep`` at n_chunks 1
  (GPipe) and 2 (interleaved, remat), tied, and at n_chunks 1 untied with
  remat: the step's loss (mean of the data ranks') against the
  reference's compiled pp-4 step (as ``tests/test_spmd_pipeline.py`` runs
  it on the 8 virtual CPU devices of conftest; rtol 1e-5) and its eager loss,
  the synced gradients against the reference's unpipelined ones (1e-5 of
  the largest entry; the tied ``wte`` counted once, every pp rank holding
  the same replicated gradients), the updated parameters by
  ``param_rule_err``'s AdamW first-step rule (1e-5), and the hybrid
  clip's scale against ``ClipGradByGlobalNorm`` on the whole gradients
  (1e-5);
- ``distributed.checkpoint`` of the pp-sharded model, loaded in this
  process into a model without a pp axis: bit-equal to the ranks'
  parameters.
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_hybrid_helpers import (assert_check, param_rule_err, rel_err,
                                   run_ranks, save_npz)
from paddle_tpu_torch.convert import load_jax_state, slice_pipe_gpt_state
from paddle_tpu_torch.distributed.fleet.meta_parallel import spmd_pipeline \
    as tsp
from paddle_tpu_torch.distributed.sharding_api import (Mesh, build_mesh,
                                                       set_default_mesh)
from paddle_tpu_torch.text.gpt import (GPTConfig, GPTForPretrainingPipe,
                                       StackedGPTBlocks)

TOL = 1e-5
KW = dict(vocab_size=64, hidden_size=32, num_layers=8, num_heads=2,
          intermediate_size=64, max_seq_len=32, dropout=0.0)
# (case, n_chunks, remat, tied)
CASES = (("gpipe", 1, False, True), ("interleaved", 2, True, True),
         ("untied_remat", 1, True, False))


@pytest.fixture
def no_interpret(monkeypatch):
    """The reference GPT takes its dense attention (other files set the
    interpret flag at import, which leaks into xdist workers)."""
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "0")


def _jax_pipe(tied=True, rms=False, mesh=None, **kw):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.sharding_api import (build_mesh as jbuild,
                                                     set_default_mesh as jset)
    from paddle_tpu.text.gpt import GPTConfig as JC, \
        GPTForPretrainingPipe as JP
    jset(mesh if mesh is not None else jbuild(dp=8))
    paddle.seed(0)
    return JP(JC(tie_word_embeddings=tied, use_rmsnorm=rms, **KW), **kw)


def _batch():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 64, (8, 32)).astype(np.int64),
            rng.integers(0, 64, (8, 32)).astype(np.int64))


def _np_state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("m,pp,v", [(4, 2, 1), (4, 4, 1), (8, 4, 2),
                                    (16, 2, 4), (1, 1, 1)])
def test_ticks_and_bubble_match_reference(m, pp, v):
    from paddle_tpu.distributed.fleet.meta_parallel import spmd_pipeline \
        as jsp
    assert tsp.pipeline_ticks(m, pp, v) == jsp.pipeline_ticks(m, pp, v)
    assert tsp.bubble_fraction(m, pp, v) == jsp.bubble_fraction(m, pp, v)


@pytest.mark.parametrize("total,pp,v", [(8, 2, 1), (8, 2, 2), (8, 4, 2),
                                        (12, 2, 3), (24, 4, 3), (6, 4, 2)])
def test_interleave_row_order_matches_reference(total, pp, v):
    from paddle_tpu.distributed.fleet.meta_parallel import spmd_pipeline \
        as jsp
    try:
        want = jsp.interleave_row_order(total, pp, v)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tsp.interleave_row_order(total, pp, v)
        assert str(te.value) == str(e)
        return
    assert np.array_equal(tsp.interleave_row_order(total, pp, v), want)


@pytest.mark.parametrize("tied,rms", [(True, False), (False, False),
                                      (True, True)])
def test_gpt_pipe_without_pp_matches_reference(no_interpret, tied, rms):
    import paddle_tpu as paddle
    jm = _jax_pipe(tied, rms, n_microbatch=4)
    state = _np_state(jm)
    ids, labels = _batch()
    jlogits, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    set_default_mesh(None)
    tm = GPTForPretrainingPipe(GPTConfig(tie_word_embeddings=tied,
                                         use_rmsnorm=rms, **KW),
                               n_microbatch=4, device="cpu")
    assert [n for n, _ in tm.named_parameters()] == list(jgrads)
    load_jax_state(tm, slice_pipe_gpt_state(state))
    logits, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    assert rel_err(logits.detach().numpy(), np.asarray(jlogits._value)) <= TOL
    assert abs(loss.item() - float(np.asarray(jloss._value))) <= TOL
    for n, p in tm.named_parameters():
        # an RMSNorm block leaves the stacked norm biases unused: no
        # gradient in the port, zeros in the reference
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        assert rel_err(g, jgrads[n]) <= TOL, n


def test_chunk_major_storage_runs_in_natural_order():
    """A model built chunk-major on a pp mesh runs its sequential loop in
    natural layer order once the mesh has no pp axis."""
    ids, labels = (torch.from_numpy(a) for a in _batch())
    set_default_mesh(None)
    plain = GPTForPretrainingPipe(GPTConfig(**KW), device="cpu")
    set_default_mesh(Mesh([1, 2, 1, 1, 1], rank=0))
    try:
        chunked = GPTForPretrainingPipe(GPTConfig(**KW), n_chunks=2,
                                        device="cpu")
    finally:
        set_default_mesh(None)
    order = tsp.interleave_row_order(8, 2, 2)
    assert torch.equal(chunked.blocks.qkv_w, plain.blocks.qkv_w[order])
    assert torch.equal(chunked(ids, labels=labels)[1],
                       plain(ids, labels=labels)[1])


def test_refusals_match_reference(recwarn):
    from paddle_tpu.text.gpt import GPTConfig as JC, StackedGPTBlocks as JS
    with pytest.raises(ValueError) as je:
        JS(JC(**dict(KW, dropout=0.1)))
    with pytest.raises(ValueError) as te:
        StackedGPTBlocks(GPTConfig(**dict(KW, dropout=0.1)), device="cpu")
    assert str(te.value) == str(je.value)
    group = type("G", (), {"nranks": 2, "rank": 0})()
    with pytest.raises(ValueError, match="divisible by pp"):
        tsp.spmd_pipeline(None, (torch.zeros(4, 1),), torch.zeros(6, 2), 3,
                          group, n_chunks=2)
    with pytest.raises(ValueError, match="must divide by pp"):
        tsp.spmd_pipeline(None, (torch.zeros(3, 1),), torch.zeros(4, 2), 2,
                          group, param_rows=6, n_chunks=2)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        tsp.spmd_pipeline_local(None, (torch.zeros(4, 1),),
                                torch.zeros(6, 2), 4, group)
    set_default_mesh(None)
    blocks = StackedGPTBlocks(GPTConfig(tensor_parallel=True, **KW),
                              device="cpu")
    x = torch.zeros(2, 32, 32)
    blocks(x)
    blocks(x)
    assert sum("tensor_parallel=True has no effect" in str(w.message)
               for w in recwarn) == 1
    # inside the pipeline each leaf keeps the reference's placement
    from jax.sharding import PartitionSpec
    specs = JS(JC(tensor_parallel=True, **KW))._tp_param_specs()
    set_default_mesh(Mesh([1, 2, 1, 1, 2], rank=0))
    try:
        blocks.commit_param_shardings()
        for name, spec in zip(blocks._param_order, specs):
            assert isinstance(spec, PartitionSpec)
            want = tuple(() if a is None else (a,) for a in spec)
            assert getattr(blocks, name)._placement.dim_axes == want, name
    finally:
        set_default_mesh(None)


def test_pipeline_compositions_left_raise_naming_a7():
    """The pipeline on a sep mesh builds (its pp groups at one sep
    coordinate), and ``sync_gradients`` takes a ZeRO-3 parameter there;
    a ``Model`` over a ``PipelineParallel`` still raises naming ROADMAP
    A7."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer, PipelineParallel, sharding)
    from paddle_tpu_torch.hapi.model import Model
    mesh = build_mesh(pp=2, sep=2, devices=4)
    assert mesh.comm_lists(("pp",)) == [[0, 2], [1, 3]]
    assert mesh.comm_lists(("sep",)) == [[0, 1], [2, 3]]
    mesh = Mesh([1, 1, 1, 2, 1], rank=0)
    p = torch.nn.Parameter(torch.zeros(2))
    p._zero = sharding.ZeroShard("p_g_os", mesh.group("sharding"), 0, (2,),
                                 None)
    g = torch.ones(2)
    assert torch.equal(sharding.sync_gradients([p], [g], mesh)[0], g)

    class Hcg:
        def get_pipe_parallel_world_size(self):
            return 1

        def get_stage_id(self):
            return 0

    pipe = PipelineParallel(PipelineLayer([torch.nn.Tanh()]), Hcg(), None)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        Model(pipe)


# -- four gloo ranks: dp 2 x pp 2 ---------------------------------------------
_WORKER = """
from paddle_tpu_torch.convert import load_jax_state, slice_pipe_gpt_state
from paddle_tpu_torch.distributed import checkpoint as dck
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
    hybrid_clip)
from paddle_tpu_torch.distributed.fleet.meta_parallel.spmd_pipeline import (
    interleave_row_order, spmd_pipeline)
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretrainingPipe

G = np.load(f"{DATA}/pipe.npz")
KW = json.loads(str(G["kw"]))
CASES = json.loads(str(G["cases"]))
ids, labels = torch.from_numpy(G["ids"]), torch.from_numpy(G["labels"])
DP, STAGE = MESH.coord["dp"], MESH.coord["pp"]
PPG = MESH.group("pp")
ROWS = slice(4 * DP, 4 * DP + 4)
assert MESH.shape["dp"] == 2 and MESH.shape["pp"] == 2
out = {}

# the explicit-rank pipeline of a tanh block against a sequential loop;
# every rank computes the same loss, so each takes a 1/pp share
gen = torch.Generator().manual_seed(1)
Ws = torch.randn(8, 16, 16, generator=gen) * 0.3
bs = torch.randn(8, 16, generator=gen) * 0.1
x0 = torch.randn(8, 16, generator=gen)


def block(p, x):
    return torch.tanh(x @ p[0] + p[1])


wr, br, xr = (t.clone().requires_grad_() for t in (Ws, bs, x0))
y = xr
for layer in range(8):
    y = block((wr[layer], br[layer]), y)
y_ref = y.detach()
(y * y).sum().backward()
for nc in (1, 2):
    order = torch.as_tensor(interleave_row_order(8, 2, nc))
    mine = order[STAGE * 4:(STAGE + 1) * 4]
    wl, bl, xl = (t.clone().requires_grad_()
                  for t in (Ws[mine], bs[mine], x0))
    y = spmd_pipeline(block, (wl, bl), xl, 4, PPG, n_chunks=nc)
    ((y * y).sum() / 2).backward()
    dx = xl.grad.clone()
    dist.all_reduce(dx, group=PPG)
    assert (y.detach() - y_ref).abs().max() <= 1e-6
    assert (wl.grad - wr.grad[mine]).abs().max() <= 1e-6 * wr.grad.abs().max()
    assert (bl.grad - br.grad[mine]).abs().max() <= 1e-6 * br.grad.abs().max()
    assert (dx - xr.grad).abs().max() <= 1e-6 * xr.grad.abs().max()
    ok(f"explicit_{nc}")

# the eager pipeline at dp 2 x pp 2: each data rank trains its half of
# the batch, and each stage's gradients are averaged over dp
from types import SimpleNamespace
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel)
from paddle_tpu_torch.optimizer import SGD


def mse(o, y):
    return ((o - y) * (o - y)).mean()


def build():
    torch.manual_seed(0)
    descs = []
    for _ in range(2):
        descs += [LayerDesc(tnn.Linear, 8, 4, device="cpu"),
                  LayerDesc(tnn.Tanh),
                  LayerDesc(tnn.Linear, 4, 8, device="cpu")]
    return PipelineLayer(descs, num_stages=2, loss_fn=mse)


class OneProcess:
    def get_pipe_parallel_world_size(self):
        return 2

    def get_stage_id(self):
        return 0

    def get_pipe_parallel_group(self):
        return SimpleNamespace(ranks=[0, 0])


rs = np.random.RandomState(3)
bx = torch.tensor(rs.randn(8, 8).astype("float32"))
by = torch.tensor(rs.randn(8, 8).astype("float32"))
strategy = fleet.get_strategy()
strategy.pipeline_configs = {"accumulate_steps": 4, "micro_batch_size": 2,
                             "schedule_mode": "1f1b"}
local = PipelineParallel(build(), OneProcess(), strategy)
want = local.train_batch((bx, by), SGD(learning_rate=0.05,
                                       parameters=local.parameters()))
strategy.pipeline_configs = dict(strategy.pipeline_configs,
                                 accumulate_steps=2)
pipe = fleet.distributed_model(build())
got = pipe.train_batch((bx[ROWS], by[ROWS]),
                       SGD(learning_rate=0.05, parameters=pipe.parameters()))
halves = []
dist.all_gather_object(halves, float(got))
assert abs((halves[0] + halves[2]) / 2 - float(want)) <= 1e-6 * float(want)
mine = [p for layer, _ in local._layers.get_stage_layers(STAGE)
        for p in layer.parameters()]
for a, b in zip(mine, pipe._layers.parameters()):
    assert (a - b).abs().max() <= 1e-6 * a.abs().max(), (a, b)
ok("eager_dp")

for case, nc, remat, tied in CASES:
    state = {k.split("/", 2)[2]: G[k] for k in G.files
             if k.startswith(f"{'tied' if tied else 'untied'}/state/")}
    m = GPTForPretrainingPipe(GPTConfig(tie_word_embeddings=tied, **KW),
                              n_microbatch=4, n_chunks=nc, remat=remat,
                              device="cpu")
    load_jax_state(m, slice_pipe_gpt_state(state, 2, None, nc))
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    step = CompiledTrainStep(lambda a, b: m(a, labels=b)[1], m, opt)
    real, seen = step._sync, {}
    step._sync = lambda g: seen.setdefault("grads", real(g))
    loss = float(step(ids[ROWS], labels[ROWS]))
    losses = []
    dist.all_gather_object(losses, loss)
    out[f"{case}/losses"] = np.array(losses)
    named = list(m.named_parameters())
    grads = seen["grads"]
    for (n, p), g in zip(named, grads):
        out[f"{case}/grad/{n}"] = gather_global(g, placement_of(p)).numpy()
        if getattr(p, "_pp_replicated", False):
            everyone = []
            dist.all_gather_object(everyone, g)
            assert all(torch.equal(everyone[0], e) for e in everyone), n
        else:
            assert tuple(p.shape)[0] == 4, (n, tuple(p.shape))
    for n, p in named:
        out[f"{case}/param/{n}"] = gather_global(p).numpy()
    params = [p for _, p in named]
    clipped = hybrid_clip(ClipGradByGlobalNorm(0.1), params, grads, MESH)
    i = max(range(len(grads)), key=lambda j: float(grads[j].abs().max()))
    flat = grads[i].abs().flatten().argmax()
    out[f"{case}/clip_scale"] = float((clipped[i] / grads[i]).flatten()[flat])
    if case == "gpipe":
        dck.save_state_dict(m.state_dict(), f"{DATA}/ckpt")
    ok(case)
if RANK == 0:
    np.savez(f"{DATA}/out.npz", **out)
dist.barrier()
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights, unpipelined gradients and eager AdamW
    step (tied and untied), and its compiled pp-4 step losses."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.sharding_api import build_mesh as jbuild
    from paddle_tpu.jit.train_step import CompiledTrainStep as JStep
    prev = os.environ.get("PDTPU_PALLAS_INTERPRET")
    os.environ["PDTPU_PALLAS_INTERPRET"] = "0"
    d = tmp_path_factory.mktemp("spmd_pipeline")
    ids, labels = _batch()
    ref = {}
    try:
        for key, tied in (("tied", True), ("untied", False)):
            jm = _jax_pipe(tied)
            state = _np_state(jm)
            _, loss = jm(paddle.to_tensor(ids),
                         labels=paddle.to_tensor(labels))
            loss.backward()
            ref[key] = {"state": state, "loss": float(np.asarray(
                loss._value)), "grads": {n: np.asarray(p.grad._value)
                                         for n, p in jm.named_parameters()}}
            paddle.optimizer.AdamW(learning_rate=1e-3,
                                   parameters=jm.parameters()).step()
            ref[key]["params"] = _np_state(jm)
        for case, nc, remat, tied in CASES[:2]:
            jm = _jax_pipe(tied, mesh=jbuild(pp=4, mp=2), n_microbatch=4,
                           n_chunks=nc, remat=remat)
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=jm.parameters())
            step = JStep(lambda i, lb, jm=jm: jm(i, labels=lb)[1], jm, opt,
                         donate=False)
            ref[f"{case}/pp4_loss"] = float(np.asarray(step(
                paddle.Tensor(ids), paddle.Tensor(labels))._value))
    finally:
        from paddle_tpu.distributed.sharding_api import set_default_mesh \
            as jset
        jset(jbuild(dp=8))
        if prev is None:
            os.environ.pop("PDTPU_PALLAS_INTERPRET", None)
        else:
            os.environ["PDTPU_PALLAS_INTERPRET"] = prev
    save_npz(d / "pipe.npz", ids=ids, labels=labels,
             kw=np.array(json.dumps(KW)), cases=np.array(json.dumps(CASES)),
             **{f"{k}/state/{n}": v for k in ("tied", "untied")
                for n, v in ref[k]["state"].items()})
    return d, ref


@pytest.fixture(scope="module")
def ranks(reference):
    d, _ = reference
    logs = run_ranks(d, _WORKER, {"dp_degree": 2, "pp_degree": 2}, nproc=4)
    return logs, dict(np.load(d / "out.npz"))


def _natural(case, name, arr):
    """A stacked tensor of the case's model back in natural layer order."""
    nc = dict((c, n) for c, n, _, _ in CASES)[case]
    if name.startswith("blocks.") and nc > 1:
        return arr[np.argsort(tsp.interleave_row_order(8, 2, nc))]
    return arr


def test_eager_pipeline_averages_stages_over_dp(ranks):
    """``PipelineParallel`` at dp 2 x pp 2, each data rank on half of an
    8-row batch in 2 microbatches, against ``_local_train`` on the whole
    batch in 4: the mean of the data ranks' losses and every stage
    parameter after one SGD step within 1e-6 (fp32)."""
    assert_check(ranks[0], "eager_dp", nproc=4)


@pytest.mark.parametrize("nc", [1, 2])
def test_explicit_rank_pipeline_against_a_sequential_loop(ranks, nc):
    assert_check(ranks[0], f"explicit_{nc}", nproc=4)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_gpt_pipe_step_loss(reference, ranks, case):
    _, ref = reference
    logs, out = ranks
    assert_check(logs, case, nproc=4)
    tied = dict((c[0], c[3]) for c in CASES)[case]
    losses = out[f"{case}/losses"]
    # rank = dp * 2 + stage: the two stages of a data rank agree
    assert losses[0] == losses[1] and losses[2] == losses[3]
    loss = (losses[0] + losses[2]) / 2
    want = ref["tied" if tied else "untied"]["loss"]
    assert abs(loss - want) <= TOL * abs(want)
    if f"{case}/pp4_loss" in ref:
        pp4 = ref[f"{case}/pp4_loss"]
        assert abs(loss - pp4) <= TOL * abs(pp4)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_gpt_pipe_gradients_and_update_match_unpipelined(reference, ranks,
                                                         case):
    _, ref = reference
    _, out = ranks
    tied = dict((c[0], c[3]) for c in CASES)[case]
    want = ref["tied" if tied else "untied"]
    for name, g_want in want["grads"].items():
        g = _natural(case, name, out[f"{case}/grad/{name}"])
        assert rel_err(g, g_want) <= TOL, name
        p = _natural(case, name, out[f"{case}/param/{name}"])
        assert param_rule_err(p, want["params"][name], g, g_want) <= TOL, \
            name


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_hybrid_clip_counts_rows_and_replicas_once(reference, ranks, case):
    _, ref = reference
    _, out = ranks
    tied = dict((c[0], c[3]) for c in CASES)[case]
    names = list(ref["tied" if tied else "untied"]["grads"])
    norm = np.sqrt(sum(np.sum(np.square(out[f"{case}/grad/{n}"]
                                        .astype(np.float64)))
                       for n in names))
    want = min(0.1 / max(norm, 1e-12), 1.0)
    assert abs(float(out[f"{case}/clip_scale"]) - want) <= TOL * want


def test_checkpoint_of_the_pp_sharded_model_loads_whole(reference, ranks):
    from paddle_tpu_torch.distributed import checkpoint as dck
    d, _ = reference
    _, out = ranks
    set_default_mesh(None)
    m = GPTForPretrainingPipe(GPTConfig(**KW), device="cpu", seed=1)
    state = m.state_dict()
    dck.load_state_dict(state, str(d / "ckpt"))
    for n, p in m.named_parameters():
        assert np.array_equal(p.detach().numpy(), out[f"gpipe/param/{n}"]), n
