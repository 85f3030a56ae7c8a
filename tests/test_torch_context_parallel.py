"""Context parallelism of the port's GPT (``text/gpt.py`` under
``context_parallel``, ``nn.functional.sep_parallel_attention``,
``sharding_api.sep_local_batch``, ``CompiledTrainStep``'s sum over sep)
against the JAX package's GPT on its sep mesh.

Four gloo ranks on the CPU are launched once for the file, first at
dp 2 x sep 2 (both data ranks feed the whole batch, so the data average
is the identity and each sep pair is the sep-2 case), then at sep 2 x
mp 2 (``tensor_parallel``), each with the ring (zigzag schedule) and with
Ulysses, on the tiny GPT of ``_torch_hybrid_helpers`` (sequence 32, 16
tokens a rank). The reference's GPT with the same ``context_parallel``
runs on its own sep mesh (and sep x mp for TP) in this process; its
weights reach the port through ``convert.py``.

- The loss, every whole gradient and every parameter after one AdamW
  step (``param_rule_err``'s first-step rule, against the reference's
  eager AdamW step from its gradients), and the losses of two compiled
  steps. The labels
  ignore 13 of each row's first 16 tokens, so the sep ranks hold very
  different counts: the loss must be the global mean (the mean of the
  ranks' own means is shown to differ).
- The hybrid clip's scale equals ``ClipGradByGlobalNorm``'s on the whole
  gradients (a parameter replicated over sep counts once).
- In one process: a mesh without sep falls back to
  ``scaled_dot_product_attention``; dropout while training raises with
  the reference's text; ``generate`` of a context-parallel model equals
  the plain model's; ``build_mesh(sep=2)`` builds; ``sep_local_batch``
  takes the rank's chunk and refuses a sequence that does not split;
  ``sequence_parallel`` with ``context_parallel`` builds, and
  ``sync_gradients`` takes a ZeRO-3 parameter on a sep mesh.
- A model that does not split the sequence on the dp 2 x sep 2 mesh,
  every rank fed the whole of it (a GPT without ``context_parallel``,
  and ERNIE): one fp32 step's loss, gradients and updated parameters
  equal the reference's step on its sep-2 mesh; its gradients take no
  sum over sep, which would double them.
- The fleet's eager loop (``distributed_model``, ``distributed_
  optimizer``, ``backward``, ``step``) on the ring GPT at both layouts:
  loss, the gradients its step synced over sep, updated parameters.

Tolerances, fp32: the losses within 1e-5 of themselves; each gradient
and parameter within 1e-5 of its largest entry.
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_helpers import TINY_ENCODER, token_batch
from _torch_hybrid_helpers import (GPT_KW, assert_check, param_rule_err,
                                   rel_err, run_ranks, save_npz)

TOL = 1e-5
MODES = ("ring", "ulysses")
LAYOUTS = ("sep2", "sep2_mp2")
# models that do not split the sequence, run on a sep mesh whole
WHOLE = ("gpt", "ernie")

_WORKER = """
from paddle_tpu_torch.convert import load_jax_state, slice_gpt_state
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
    hybrid_clip)
from paddle_tpu_torch.distributed.sharding_api import sep_local_batch
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining

G = np.load(f"{DATA}/gpt.npz")
KW = json.loads(str(G["kw"]))
ids, labels = torch.from_numpy(G["ids"]), torch.from_numpy(G["labels"])
out = {}


def run(layout, mode, mp):
    state = {k[len(f"{layout}/state/"):]: G[k] for k in G.files
             if k.startswith(f"{layout}/state/")}
    mesh = get_default_mesh()
    m = GPTForPretraining(GPTConfig(context_parallel=mode,
                                    tensor_parallel=mp > 1, **KW),
                          device="cpu")
    load_jax_state(m, slice_gpt_state(state, mp, mesh.coord["mp"]))
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    step = CompiledTrainStep(lambda a, b: m(a, labels=b)[1], m, opt)
    real, seen = step._sync, {}
    step._sync = lambda g: seen.setdefault("grads", real(g))
    li, ll = sep_local_batch(ids), sep_local_batch(labels)
    key = f"{layout}/{mode}"
    out[f"{key}/loss1"] = np.float64(step(li, ll))
    named = list(m.named_parameters())
    for (n, p), g in zip(named, seen["grads"]):
        out[f"{key}/grad/{n}"] = gather_global(g, placement_of(p)).numpy()
    for n, p in named:
        out[f"{key}/param/{n}"] = gather_global(p).numpy()
    grads = seen["grads"]
    clipped = hybrid_clip(ClipGradByGlobalNorm(0.1), [p for _, p in named],
                          grads, mesh)
    i = max(range(len(named)), key=lambda j: float(grads[j].abs().max()))
    out[f"{key}/clip_scale"] = float((clipped[i] / grads[i]).flatten()[
        grads[i].abs().flatten().argmax()])
    out[f"{key}/loss2"] = np.float64(step(li, ll))
    # the mean of the sep ranks' own means (not the reference's loss)
    with torch.no_grad():
        logits = m(li)
    if mp > 1:
        from paddle_tpu_torch.distributed.fleet.meta_parallel import \\
            ParallelCrossEntropy
        per = ParallelCrossEntropy()(logits.float(), ll)
        own = per.sum() / (ll != -100).sum()
    else:
        own = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), ll.reshape(-1),
            ignore_index=-100)
    means = []
    dist.all_gather_object(means, float(own))
    out[f"{key}/mean_of_means"] = float(np.mean(means[:2]))
    ok(key)


def run_eager(layout, mp):
    # the fleet's eager loop: distributed_model, distributed_optimizer,
    # backward and step (the optimizer sums over sep); the synced
    # gradients seen by its step
    from paddle_tpu_torch.distributed.fleet.meta_parallel import sharding
    state = {k[len(f"{layout}/state/"):]: G[k] for k in G.files
             if k.startswith(f"{layout}/state/")}
    m = GPTForPretraining(GPTConfig(context_parallel="ring",
                                    tensor_parallel=mp > 1, **KW),
                          device="cpu")
    load_jax_state(m, slice_gpt_state(state, mp, MESH.coord["mp"]))
    model = fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(
        AdamW(learning_rate=1e-3, parameters=m.parameters()))
    real, seen = sharding.sync_gradients, {}

    def spy(*a, **k):
        seen["grads"] = real(*a, **k)
        return seen["grads"]

    sharding.sync_gradients = spy
    try:
        loss = model(sep_local_batch(ids), labels=sep_local_batch(labels))[1]
        loss.backward()
        opt.step()
    finally:
        sharding.sync_gradients = real
    key = f"{layout}/eager"
    out[f"{key}/loss1"] = np.float64(loss.detach())
    named = [(n, p) for n, p in m.named_parameters() if p.grad is not None]
    for (n, p), g in zip(named, seen["grads"]):
        out[f"{key}/grad/{n}"] = gather_global(g, placement_of(p)).numpy()
    for n, p in m.named_parameters():
        out[f"{key}/param/{n}"] = gather_global(p).numpy()
    ok(key)


def run_whole(name):
    # a model that does not split the sequence, every sep rank fed the
    # whole of it: its gradient is the rank's own and takes no sum over sep
    state = {k[len(f"whole/{name}/state/"):]: G[k] for k in G.files
             if k.startswith(f"whole/{name}/state/")}
    if name == "gpt":
        m = GPTForPretraining(GPTConfig(**KW), device="cpu")
        batch = ids, labels
    else:
        from paddle_tpu_torch.text.ernie import (ErnieConfig,
                                                 ErnieForPretraining)
        m = ErnieForPretraining(ErnieConfig(**json.loads(str(G["ernie_kw"]))),
                                device="cpu")
        batch = (torch.from_numpy(G["ernie_ids"]),
                 torch.from_numpy(G["ernie_labels"]))
    load_jax_state(m, state)
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    step = CompiledTrainStep(lambda a, b: m(a, labels=b)[1], m, opt)
    real, seen = step._sync, {}
    step._sync = lambda g: seen.setdefault("grads", real(g))
    key = f"whole/{name}"
    out[f"{key}/loss"] = np.float64(step(*batch))
    named = list(m.named_parameters())
    for (n, p), g in zip(named, seen["grads"]):
        out[f"{key}/grad/{n}"] = g.numpy().copy()
    for n, p in named:
        out[f"{key}/param/{n}"] = p.detach().numpy().copy()
    ok(key)


for mode in ("ring", "ulysses"):
    run("sep2", mode, 1)
MESH = get_default_mesh()
run_eager("sep2", 1)
for name in ("gpt", "ernie"):
    run_whole(name)

strategy = fleet.DistributedStrategy()
strategy.hybrid_configs = {"dp_degree": 1, "sep_degree": 2, "mp_degree": 2}
fleet.init(is_collective=True, strategy=strategy)
for mode in ("ring", "ulysses"):
    run("sep2_mp2", mode, 2)
MESH = get_default_mesh()
run_eager("sep2_mp2", 2)
if RANK == 0:
    np.savez(f"{DATA}/port.npz", **out)
ok("saved")
"""


def _jax_state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def _reference(layout, mode, ids, labels):
    """The JAX GPT with ``context_parallel=mode`` on its sep-2 mesh (sep 2
    x mp 2 with ``tensor_parallel`` for "sep2_mp2"): its weights, the
    eager loss and whole gradients, the parameters after an eager AdamW
    step, and the losses of two compiled steps on the batch sharded
    ``P("dp", "sep")``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import paddle_tpu as paddle
    from paddle_tpu.distributed.sharding_api import (build_mesh,
                                                     set_default_mesh)
    from paddle_tpu.jit.train_step import CompiledTrainStep
    from paddle_tpu.text.gpt import GPTConfig, GPTForPretraining
    mp = 2 if layout == "sep2_mp2" else 1
    mesh = set_default_mesh(build_mesh(dp=1, sep=2, mp=mp,
                                       devices=jax.devices()[:2 * mp]))
    try:
        paddle.seed(0)
        jm = GPTForPretraining(GPTConfig(tensor_parallel=mp > 1,
                                         context_parallel=mode, **GPT_KW))
        state = _jax_state(jm)
        _, loss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss.backward()
        grads = {n: np.asarray(p.grad._value)
                 for n, p in jm.named_parameters()}
        paddle.optimizer.AdamW(learning_rate=1e-3,
                               parameters=jm.parameters()).step()
        params = _jax_state(jm)
        jm.clear_gradients()
        jm.set_state_dict(state)
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=jm.parameters())
        step = CompiledTrainStep(lambda i, lb: jm(i, labels=lb)[1], jm, opt,
                                 donate=False)
        sh = NamedSharding(mesh, P("dp", "sep"))
        ti, tl = (paddle.Tensor(jax.device_put(jnp.asarray(a), sh))
                  for a in (ids, labels))
        loss1 = float(np.asarray(step(ti, tl)._value))
        loss2 = float(np.asarray(step(ti, tl)._value))
    finally:
        set_default_mesh(None)
    return {"state": state, "grads": grads, "params": params,
            "loss0": float(np.asarray(loss._value)), "loss1": loss1,
            "loss2": loss2}


def _whole_reference(ids, labels, e_ids, e_labels):
    """The JAX GPT without ``context_parallel`` and the tiny ERNIE on their
    own sep-2 mesh, each fed the whole sequence: weights, loss, gradients
    and the parameters after an eager AdamW step."""
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.distributed.sharding_api import (build_mesh,
                                                     set_default_mesh)
    from paddle_tpu.text.ernie import ErnieConfig, ErnieForPretraining
    from paddle_tpu.text.gpt import GPTConfig, GPTForPretraining
    set_default_mesh(build_mesh(dp=1, sep=2, devices=jax.devices()[:2]))
    ref = {}
    try:
        for name in WHOLE:
            paddle.seed(0)
            if name == "gpt":
                jm, batch = GPTForPretraining(GPTConfig(**GPT_KW)), \
                    (ids, labels)
            else:
                jm, batch = ErnieForPretraining(ErnieConfig(
                    **TINY_ENCODER)), (e_ids, e_labels)
            state = _jax_state(jm)
            _, loss = jm(*(paddle.to_tensor(a) for a in batch[:1]),
                         labels=paddle.to_tensor(batch[1]))
            loss.backward()
            for p in jm.parameters():
                if p.grad is None:
                    # ERNIE's MLM loss never reads the pooler: the
                    # compiled step updates it from a zero gradient
                    p.grad = paddle.zeros_like(p)
            grads = {n: np.asarray(p.grad._value)
                     for n, p in jm.named_parameters()}
            paddle.optimizer.AdamW(learning_rate=1e-3,
                                   parameters=jm.parameters()).step()
            ref[name] = {"state": state, "grads": grads,
                         "params": _jax_state(jm),
                         "loss": float(np.asarray(loss._value))}
    finally:
        set_default_mesh(None)
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("context_parallel")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, (4, 32)).astype(np.int64)
    labels = rng.integers(0, 128, (4, 32)).astype(np.int64)
    labels[:, :13] = -100          # sep rank 0 keeps 3 of its 16 a row
    labels[1, 20] = -100
    old = os.environ.get("PDTPU_PALLAS_INTERPRET")
    os.environ["PDTPU_PALLAS_INTERPRET"] = "0"   # the JAX dense attention
    try:
        ref = {(lay, mode): _reference(lay, mode, ids, labels)
               for lay in LAYOUTS for mode in MODES}
        e_ids, e_labels = token_batch(7)
        whole = _whole_reference(ids, labels, e_ids, e_labels)
    finally:
        if old is None:
            os.environ.pop("PDTPU_PALLAS_INTERPRET", None)
        else:
            os.environ["PDTPU_PALLAS_INTERPRET"] = old
    save_npz(d / "gpt.npz", ids=ids, labels=labels,
             kw=np.array(json.dumps(GPT_KW)),
             ernie_kw=np.array(json.dumps(TINY_ENCODER)), ernie_ids=e_ids,
             ernie_labels=e_labels,
             **{f"{lay}/state/{k}": v
                for lay in LAYOUTS
                for k, v in ref[(lay, "ring")]["state"].items()},
             **{f"whole/{name}/state/{k}": v
                for name in WHOLE for k, v in whole[name]["state"].items()})
    logs = run_ranks(d, _WORKER, {"dp_degree": 2, "sep_degree": 2},
                     nproc=4)
    return {"logs": logs, "ref": ref, "whole": whole,
            "port": dict(np.load(d / "port.npz"))}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_gpt_step_matches_the_reference(run, layout, mode):
    assert_check(run["logs"], f"{layout}/{mode}", nproc=4)
    ref, port = run["ref"][(layout, mode)], run["port"]
    key = f"{layout}/{mode}"
    for got, want in ((port[f"{key}/loss1"], ref["loss0"]),
                      (port[f"{key}/loss1"], ref["loss1"]),
                      (port[f"{key}/loss2"], ref["loss2"])):
        assert abs(got - want) <= TOL * abs(want), (got, want)
    assert ref["loss2"] < ref["loss1"]
    for n, want in ref["grads"].items():
        got = port[f"{key}/grad/{n}"]
        assert got.shape == want.shape, n
        assert rel_err(got, want) <= TOL, (n, rel_err(got, want))
    for n, want in ref["params"].items():
        err = param_rule_err(port[f"{key}/param/{n}"], want,
                             port[f"{key}/grad/{n}"], ref["grads"][n])
        assert err <= TOL, (n, err)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_loss_is_the_global_mean_not_a_mean_of_rank_means(run, layout):
    port, ref = run["port"], run["ref"][(layout, "ring")]
    key = f"{layout}/ring"
    assert abs(port[f"{key}/loss1"] - ref["loss0"]) <= TOL * ref["loss0"]
    assert abs(port[f"{key}/mean_of_means"] - ref["loss0"]) > \
        1e-2 * ref["loss0"]


@pytest.mark.parametrize("name", WHOLE)
def test_whole_sequence_on_a_sep_mesh_takes_no_sum_over_sep(run, name):
    """A GPT without ``context_parallel``, and ERNIE, on the dp 2 x sep 2
    mesh with every rank fed the whole sequence (each data rank a dp 1 x
    sep 2 mesh): one fp32 ``CompiledTrainStep`` holds its loss, synced
    gradients and AdamW-updated parameters to the reference's step on its
    sep-2 mesh. Each sep rank's gradient is already the whole one, so a
    sum over sep would double it. A gradient zero up to rounding in the
    reference (ERNIE's k biases, which softmax cancels: below 1e-6 of the
    model's largest entry) must be so in the port as well."""
    assert_check(run["logs"], f"whole/{name}", nproc=4)
    ref, port = run["whole"][name], run["port"]
    key = f"whole/{name}"
    assert abs(port[f"{key}/loss"] - ref["loss"]) <= TOL * ref["loss"]
    top = max(float(np.abs(g).max()) for g in ref["grads"].values())
    for n, want in ref["grads"].items():
        got = port[f"{key}/grad/{n}"]
        assert got.shape == want.shape, n
        if float(np.abs(want).max()) <= 1e-6 * top:
            assert float(np.abs(got).max()) <= 1e-6 * top, n
            continue
        assert rel_err(got, want) <= TOL, (n, rel_err(got, want))
    for n, want in ref["params"].items():
        got = port[f"{key}/param/{n}"]
        if not want.any():
            # a zero bias the loss never reads (ERNIE's pooler) stays zero
            assert not got.any(), n
            continue
        err = param_rule_err(got, want, port[f"{key}/grad/{n}"],
                             ref["grads"][n])
        assert err <= TOL, (n, err)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_hybrid_clip_counts_sep_replicas_once(run, layout):
    grads = run["ref"][(layout, "ring")]["grads"]
    norm = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                       for g in grads.values()))
    want = min(0.1 / norm, 1.0)
    assert want < 1.0
    for mode in MODES:
        got = run["port"][f"{layout}/{mode}/clip_scale"]
        assert abs(got - want) <= TOL * want, (mode, got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_eager_fleet_step_matches_the_reference(run, layout):
    """``fleet.distributed_model`` and ``distributed_optimizer`` around the
    ring GPT: the eager loss, the gradients the optimizer's step synced
    (summed over sep) and the updated parameters."""
    assert_check(run["logs"], f"{layout}/eager", nproc=4)
    ref, port = run["ref"][(layout, "ring")], run["port"]
    key = f"{layout}/eager"
    assert abs(port[f"{key}/loss1"] - ref["loss0"]) <= TOL * ref["loss0"]
    for n, want in ref["grads"].items():
        got = port[f"{key}/grad/{n}"]
        assert got.shape == want.shape, n
        assert rel_err(got, want) <= TOL, (n, rel_err(got, want))
    for n, want in ref["params"].items():
        err = param_rule_err(port[f"{key}/param/{n}"], want,
                             port[f"{key}/grad/{n}"], ref["grads"][n])
        assert err <= TOL, (n, err)


# -- one process --------------------------------------------------------------
@pytest.fixture
def default_mesh():
    """Set the port's default mesh for a test and restore it after."""
    from paddle_tpu_torch.distributed import sharding_api as sa
    old = sa.peek_default_mesh()
    yield sa.set_default_mesh
    sa.set_default_mesh(old)


def _sep_layout(n=2):
    """A mesh of ``n`` sep ranks as a layout (rank 0, no process group)."""
    from paddle_tpu_torch.distributed.sharding_api import Mesh
    return Mesh([1, 1, 1, n, 1], rank=0)


def _qkv(seed=0, shape=(2, 128, 2, 64)):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) for _ in range(3)]


def test_a_mesh_without_sep_falls_back(default_mesh):
    from paddle_tpu_torch.distributed.sharding_api import build_mesh
    from paddle_tpu_torch.nn import functional as F
    default_mesh(build_mesh(dp=1, devices=1))
    q, k, v = _qkv()
    for causal in (True, False):
        got = F.sep_parallel_attention(q, k, v, is_causal=causal)
        want = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        assert torch.equal(got, want)


def test_dropout_under_sep_raises_as_in_the_reference(default_mesh):
    from paddle_tpu_torch.nn import functional as F
    default_mesh(_sep_layout())
    q, k, v = _qkv()
    with pytest.raises(NotImplementedError,
                       match="not supported under context parallelism"):
        F.sep_parallel_attention(q, k, v, is_causal=True, dropout_p=0.1)


def test_generate_is_unchanged_under_context_parallel(default_mesh):
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    default_mesh(_sep_layout())
    plain = GPTForPretraining(GPTConfig(**GPT_KW), device="cpu", seed=3)
    ids = torch.randint(0, 128, (2, 7), generator=torch.Generator()
                        .manual_seed(1))
    for mode in MODES:
        cp = GPTForPretraining(GPTConfig(context_parallel=mode, **GPT_KW),
                               device="cpu", seed=3)
        assert torch.equal(cp.generate(ids, max_new_tokens=6),
                           plain.generate(ids, max_new_tokens=6))


def test_build_mesh_with_sep_builds():
    from paddle_tpu_torch.distributed.sharding_api import build_mesh
    mesh = build_mesh(sep=2, devices=2)
    assert mesh.shape["sep"] == 2 and mesh.shape["dp"] == 1
    assert mesh.group("sep").ranks == [0, 1]
    mesh = build_mesh(dp=2, sep=2, mp=2, devices=8)
    assert [mesh.shape[a] for a in ("dp", "sep", "mp")] == [2, 2, 2]


def test_sep_local_batch_takes_the_rank_chunk():
    from paddle_tpu_torch.distributed.sharding_api import Mesh, sep_local_batch
    x = torch.arange(2 * 12).reshape(2, 12)
    for rank, want in ((0, x[:, :6]), (1, x[:, 6:])):
        mesh = Mesh([1, 1, 1, 2, 1], rank=rank)
        assert torch.equal(sep_local_batch(x, mesh), want)
    assert torch.equal(sep_local_batch(x, Mesh([1, 1, 1, 1, 1], rank=0)), x)
    with pytest.raises(ValueError, match="does not split over the sep"):
        sep_local_batch(x[:, :5], Mesh([1, 1, 1, 2, 1], rank=0))


def test_the_rest_of_sep_raises_naming_a7(default_mesh):
    """What once raised naming ROADMAP A7 composes with sep now (the
    eight-rank steps are ``tests/test_torch_context_hybrid.py``'s): a
    context-parallel GPT with ``sequence_parallel`` builds, its parameters
    marked for the sum over sep and its norms sequence-parallel, and
    ``sync_gradients`` takes a ZeRO-3 parameter on a sep mesh (a layout:
    its groups have no process group, so the sums are the identity)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        ZeroShard, sync_gradients)
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    mesh = default_mesh(_sep_layout())
    m = GPTForPretraining(GPTConfig(context_parallel="ring",
                                    sequence_parallel=True, **GPT_KW),
                          device="cpu")
    assert all(p._sep_partial for p in m.parameters())
    assert all(getattr(p, "sequence_parallel", False)
               for n, p in m.named_parameters() if ".ln" in n)
    p = torch.nn.Parameter(torch.zeros(2))
    p._zero = ZeroShard("p_g_os", mesh.group("sharding"), 0, (2,), None)
    p._sep_partial = True
    g = torch.arange(2.0)
    assert torch.equal(sync_gradients([p], [g], mesh)[0], g)
