"""The semi-auto parallel API of the port (``paddle_tpu_torch.distributed.
auto_parallel``) on four gloo ranks on the CPU, launched once for the file,
held against the JAX package's ``auto_parallel`` in this process (on the
session's 8 virtual CPU devices), from the same numpy inputs and weights
(``convert.load_jax_state``):

- the reference's own cases (``tests/test_auto_parallel.py``) mirrored:
  the mesh's shape, names and groups, rank validation, the placement
  predicates, ``shard_tensor``'s pieces (one axis; two axes on one dim),
  ``reshard`` changing placements, ``shard_layer`` replicating by
  default, ``predict`` on a single-field dataset;
- every ``reshard`` move (all-gather, slice, all-to-all, a nested split,
  another mesh over the same ranks) round-tripping bit-equal;
- the reference's ``test_engine_tp_matches_single_device`` at its sizes,
  by the JAX ``Engine`` and by the port's ``Engine``, on
  ``ProcessMesh(range(4), ["mp"])`` and on ``[[0, 1], [2, 3]]`` as
  ("dp", "mp"): the first step's loss and gathered gradients within 1e-5
  (of the largest entry) of the JAX ones, the two-epoch history within
  2e-4 relative (the reference's own bound between its TP ``Engine`` and
  one device); a second average, or none, of the gradients fails the
  1e-5 bound;
- a 2-layer GPT whose tied ``wte`` is placed ``Shard(0)``: the first
  step's loss, gradients and updated parameters against the JAX
  ``Engine``'s at 1e-5;
- ``Engine.save``/``load``: the files hold the gathered state bit for bit
  and a load resumes bit-identically;
- ``Partial`` refused, as in the reference.
"""
import numpy as np
import pytest

from _torch_hybrid_helpers import (GPT_KW, assert_check, param_rule_err,
                                   rel_err, run_ranks, save_npz)

TOL = 1e-5
NPROC = 4
BLOCK_KW = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                intermediate_size=64, max_seq_len=16, dropout=0.0)
# the reference test's placements of its block, by parameter name
BLOCK_PLACEMENTS = [("0.attn.qkv_proj.weight", 1), ("0.attn.qkv_proj.bias", 0),
                    ("0.attn.out_proj.weight", 0), ("0.mlp.fc_in.weight", 1),
                    ("0.mlp.fc_in.bias", 0), ("0.mlp.fc_out.weight", 0)]
MESHES = {"mp4": ([0, 1, 2, 3], ["mp"]),
          "dp2_mp2": ([[0, 1], [2, 3]], ["dp", "mp"])}
GPT_BATCH = 8

_WORKER = """
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed.auto_parallel as ap
from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import load_jax_gpt, load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.gpt import GPTBlock, GPTConfig, GPTForPretraining

paddle.set_device("cpu")
S, R = dist.Shard, dist.Replicate
ref = dict(np.load(DATA + "/ref.npz", allow_pickle=True))
out = {}


def same(a, b):
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), (a, b)


def raises(exc, fn):
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{fn} did not raise {exc}")


# -- the reference's own cases ---------------------------------------------
mesh = dist.ProcessMesh([[0, 1], [2, 3]], dim_names=["x", "y"])
assert mesh.shape == [2, 2] and mesh.dim_names == ["x", "y"]
assert mesh.process_ids == [0, 1, 2, 3] and mesh.get_dim_size("y") == 2
cx, cy = mesh.coord["x"], mesh.coord["y"]
assert (cx, cy) == divmod(RANK, 2)
assert mesh.group("y").ranks == [2 * cx, 2 * cx + 1]
assert mesh.line("x") == [cy, 2 + cy]
raises(ValueError, lambda: dist.ProcessMesh([[0, 99]]))
raises(ValueError, lambda: dist.ProcessMesh([[0, 0]]))
raises(ValueError, lambda: dist.ProcessMesh([[0, 1, 2, 3, 4]]))
ok("process_mesh")

t = torch.arange(32, dtype=torch.float32).reshape(8, 4)
st = dist.shard_tensor(t, mesh, [S(0), R()])
assert tuple(st.shape) == (4, 4)
same(st, t[4 * cx:4 * cx + 4])
same(gather_global(st), t)
assert st._dist_attr[1] == [S(0), R()]
z = dist.shard_tensor(torch.arange(64.).reshape(8, 8), mesh, [S(0), S(0)])
assert tuple(z.shape) == (2, 8)
same(z, torch.arange(64.).reshape(8, 8)[2 * (2 * cx + cy):][:2])
pt = dist.shard_tensor(paddle.to_tensor(t.numpy()), mesh, [R(), S(1)])
assert isinstance(pt, paddle.Tensor) and pt._dist_attr[1] == [R(), S(1)]
same(pt._value, t[:, 2 * cy:2 * cy + 2])
ok("shard_tensor")

rt = dist.reshard(st, mesh, [R(), S(1)])
same(rt, t[:, 2 * cy:2 * cy + 2])
full = dist.unshard_dtensor(rt)
assert getattr(full, "_dist_attr", None) is None
same(full, t)
ok("reshard_changes_placement")

line = dist.ProcessMesh(list(range(4)), dim_names=["x"])
net = nn.Linear(4, 4, device="cpu")
w0 = net.weight.detach().clone()
dist.shard_layer(net, line)
assert net.weight._dist_attr == (line, [R()])
same(net.weight, w0)
ok("shard_layer_default_replicates")

net = nn.Linear(4, 2, device="cpu")
xs = torch.as_tensor(ref["predict_x"])


class _X(paddle.io.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        return xs[i].numpy()


outs = dist.Engine(net, mesh=line).predict(_X(), batch_size=8)
assert len(outs) == 1 and tuple(outs[0].shape) == (8, 2)
torch.testing.assert_close(outs[0], net(xs), rtol=1e-6, atol=1e-6)
ok("predict_single_field")

# -- every reshard move, round trips bit-equal --------------------------------
g = torch.Generator().manual_seed(3)
w = torch.randn(8, 12, generator=g)


def piece(mesh, pls):
    return dist.shard_tensor(w, mesh, pls)


a = piece(line, [S(1)])
for pls in ([R()], [S(0)], [S(1)]):
    a = dist.reshard(a, line, pls)
    same(a, piece(line, pls))
b = piece(mesh, [S(0), S(1)])
for pls in ([S(1), S(0)], [S(0), S(0)], [R(), S(0)], [S(1), R()],
            [S(0), S(1)]):
    b = dist.reshard(b, mesh, pls)
    same(b, piece(mesh, pls))
other = dist.ProcessMesh([[0, 2], [1, 3]], dim_names=["x", "y"])
c = dist.reshard(piece(mesh, [S(0), S(1)]), other, [S(1), S(0)])
same(c, piece(other, [S(1), S(0)]))
same(dist.unshard_dtensor(c), w)
ap.reset_stats()
dist.reshard(piece(line, [S(1)]), line, [R()])
assert ap.stats()["collectives"] == 1
ok("reshard_moves")


# -- the reference's TP test: the block trained by the Engine ------------------
class _Data(paddle.io.Dataset):
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def mse(out, y):
    return torch.mean(torch.square(out - y))


block_state = {k[len("block/"):]: v for k, v in ref.items()
               if k.startswith("block/")}


def build_block(mesh=None):
    cfg = GPTConfig(**json.loads(str(ref["block_kw"])))
    model = nn.Sequential(GPTBlock(cfg, device="cpu"),
                          nn.Linear(32, 8, device="cpu"))
    load_jax_state(model, block_state)
    if mesh is not None:
        params = dict(model.named_parameters())
        for name, d in json.loads(str(ref["block_placements"])):
            pls = [R() for _ in range(mesh.ndim)]
            pls[-1] = S(d)
            dist.shard_tensor(params[name], mesh, pls)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    return model, opt


data = _Data(ref["block_x"], ref["block_y"])
for key, (ids, names) in json.loads(str(ref["meshes"])).items():
    m = dist.ProcessMesh(ids, names)
    model, opt = build_block(m)
    eng = dist.Engine(model, loss=mse, optimizer=opt, mesh=m)
    eng.prepare()
    batch = next(iter(paddle.io.DataLoader(data, batch_size=4)))
    fields, split = eng._fields(batch)
    assert split
    loss, grads = eng._forward_backward(fields, split)
    names_ = [n for n, p in model.named_parameters()]
    whole = {n: dist.unshard_dtensor(g) for n, g in zip(names_, grads)}
    # the faults the bounds must catch: a second average, and none
    real = eng._sync
    eng._sync = lambda gs, s: [x / m.shape[0] for x in real(gs, s)]
    _, g2 = eng._forward_backward(fields, split)
    eng._sync = lambda gs, s: real(gs, False)
    _, g0 = eng._forward_backward(fields, False)
    eng._sync = real
    losses = []
    dist.all_gather_object(losses, float(loss))
    hist = eng.fit(data, epochs=2, batch_size=4)
    seen = []
    dist.all_gather_object(seen, hist["loss"])
    assert all(h == seen[0] for h in seen), seen
    out.update({f"{key}/loss_ranks": np.array(losses),
                f"{key}/hist": np.array(hist["loss"])})
    out.update({f"{key}/grad/{n}": v.numpy() for n, v in whole.items()})
    out.update({f"{key}/grad2/{n}": dist.unshard_dtensor(v).numpy()
                for n, v in zip(names_, g2)})
    out.update({f"{key}/grad0/{n}": dist.unshard_dtensor(v).numpy()
                for n, v in zip(names_, g0)})
ok("engine_tp")

# -- save / load: the gathered state, and a bit-identical resume ---------------
m = dist.ProcessMesh(list(range(4)), ["mp"])
model, opt = build_block(m)
eng = dist.Engine(model, loss=mse, optimizer=opt, mesh=m)
eng.fit(data, epochs=1, batch_size=4)
eng.save(DATA + "/ckpt")
saved = paddle.load(DATA + "/ckpt.pdparams", return_numpy=True)
for n, p in model.named_parameters():
    same(dist.unshard_dtensor(p), saved[n])
model2, opt2 = build_block(m)
eng2 = dist.Engine(model2, loss=mse, optimizer=opt2, mesh=m)
eng2.load(DATA + "/ckpt")
h1 = eng.fit(data, epochs=1, batch_size=4)
h2 = eng2.fit(data, epochs=1, batch_size=4)
assert h1 == h2, (h1, h2)
for (n, p), q in zip(model.named_parameters(), model2.parameters()):
    same(p, q)
ok("save_load")

# -- a 2-layer GPT with its tied wte placed Shard(0) ---------------------------
cfg = GPTConfig(**json.loads(str(ref["gpt_kw"])))
gpt = GPTForPretraining(cfg, device="cpu")
load_jax_gpt(gpt, {k[len("gpt/"):]: v for k, v in ref.items()
                   if k.startswith("gpt/")})
params = dict(gpt.named_parameters())
dist.shard_tensor(params["gpt.wte.weight"], m, [S(0)])
for i in range(cfg.num_layers):
    for name, d in json.loads(str(ref["block_placements"])):
        dist.shard_tensor(params[name.replace("0.", f"gpt.blocks.{i}.", 1)],
                          m, [S(d)])
opt = AdamW(learning_rate=1e-3, parameters=gpt.parameters(),
            grad_clip=ClipGradByGlobalNorm(1.0))
vocab = cfg.vocab_size
eng = dist.Engine(gpt, optimizer=opt, mesh=m, loss=lambda lg, lb:
                  F.cross_entropy(lg.reshape(-1, vocab), lb.reshape(-1)))
eng.prepare()
gdata = _Data(ref["gpt_ids"], ref["gpt_labels"])
loader = dist.shard_dataloader(
    paddle.io.DataLoader(gdata, batch_size=len(gdata)), [m])
fields, split = eng._fields(next(iter(loader)))
assert split and fields[0].shape[0] == len(gdata) // m.shape[0]
_, grads = eng._forward_backward(fields, split)
hist = eng.fit(loader, epochs=1)
out["gpt/loss"] = np.array(hist["loss"][0])
for (n, p), g in zip(gpt.named_parameters(), grads):
    out[f"gpt/grad/{n}"] = dist.unshard_dtensor(g).numpy()
    out[f"gpt/param/{n}"] = dist.unshard_dtensor(p).detach().numpy()
ok("engine_gpt_tied")

if RANK == 0:
    np.savez(DATA + "/port.npz", **out)
dist.barrier()
ok("done")
"""


def _jax_reference(d):
    """The JAX package's side: the block's and GPT's weights, the first
    step's eager gradients and the JAX Engine's results on each mesh."""
    import json

    import paddle_tpu as paddle
    import paddle_tpu.distributed as dist
    from paddle_tpu.distributed import sharding_api as sa
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu.text.gpt import GPTBlock, GPTConfig, GPTForPretraining

    rng = np.random.default_rng(0)
    xs = rng.standard_normal((8, 16, 32)).astype("float32")
    ys = rng.standard_normal((8, 16, 8)).astype("float32")

    class _Data(paddle.io.Dataset):
        def __init__(self, *fields):
            self.fields = fields

        def __len__(self):
            return len(self.fields[0])

        def __getitem__(self, i):
            return tuple(f[i] for f in self.fields)

    def state(model):
        return {k: np.asarray(v._value)
                for k, v in model.state_dict().items()}

    def build_block():
        paddle.seed(11)
        block = GPTBlock(GPTConfig(**BLOCK_KW))
        model = paddle.nn.Sequential(block, paddle.nn.Linear(32, 8))
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=model.parameters())
        return model, opt

    def place(model, mesh, placements):
        params = dict(model.named_parameters())
        for name, dim in placements:
            p = params[name]
            pls = [dist.Replicate()] * (mesh.ndim - 1) + [dist.Shard(dim)]
            p._value = dist.shard_tensor(paddle.Tensor(p._value), mesh,
                                         pls)._value

    before = sa.peek_default_mesh()
    out = {}
    try:
        model, _ = build_block()
        block_state = state(model)
        loss = paddle.nn.MSELoss()(model(paddle.to_tensor(xs[:4])),
                                   paddle.to_tensor(ys[:4]))
        loss.backward()
        out["block_loss"] = float(np.asarray(loss._value))
        out["block_grads"] = {n: np.asarray(p.grad._value)
                              for n, p in model.named_parameters()}
        for key, (ids, names) in MESHES.items():
            mesh = dist.ProcessMesh(ids, dim_names=names)
            model, opt = build_block()
            place(model, mesh, BLOCK_PLACEMENTS)
            eng = dist.Engine(model, loss=paddle.nn.MSELoss(), optimizer=opt,
                              mesh=mesh)
            out[f"{key}/hist"] = eng.fit(_Data(xs, ys), epochs=2,
                                         batch_size=4)["loss"]

        # the 2-layer GPT with its tied wte placed
        gpt_kw = dict(GPT_KW)
        grng = np.random.default_rng(7)
        ids = grng.integers(0, gpt_kw["vocab_size"],
                            (GPT_BATCH, gpt_kw["max_seq_len"])).astype(
                                np.int64)
        labels = grng.integers(0, gpt_kw["vocab_size"],
                               ids.shape).astype(np.int64)
        vocab = gpt_kw["vocab_size"]

        def ce(logits, lb):
            return paddle.nn.functional.cross_entropy(
                paddle.reshape(logits, [-1, vocab]), paddle.reshape(lb, [-1]))

        def build_gpt():
            paddle.seed(0)
            return GPTForPretraining(GPTConfig(**gpt_kw))

        gpt = build_gpt()
        gpt_state = state(gpt)
        loss = ce(gpt(paddle.to_tensor(ids)), paddle.to_tensor(labels))
        loss.backward()
        out["gpt_grads"] = {n: np.asarray(p.grad._value)
                            for n, p in gpt.named_parameters()}
        mesh = dist.ProcessMesh(list(range(4)), dim_names=["mp"])
        gpt = build_gpt()
        gpt_places = [("gpt.wte.weight", 0)] + [
            (n.replace("0.", f"gpt.blocks.{i}.", 1), dim)
            for i in range(gpt_kw["num_layers"])
            for n, dim in BLOCK_PLACEMENTS]
        place(gpt, mesh, gpt_places)
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=gpt.parameters(),
                                     grad_clip=ClipGradByGlobalNorm(1.0))
        eng = dist.Engine(gpt, loss=ce, optimizer=opt, mesh=mesh)
        out["gpt_loss"] = eng.fit(_Data(ids, labels), epochs=1,
                                  batch_size=GPT_BATCH)["loss"][0]
        out["gpt_params"] = {n: np.asarray(p._value)
                             for n, p in gpt.named_parameters()}
    finally:
        sa.set_default_mesh(before)

    save_npz(d / "ref.npz", block_x=xs, block_y=ys,
             predict_x=rng.standard_normal((8, 4)).astype("float32"),
             block_kw=np.array(json.dumps(BLOCK_KW)),
             block_placements=np.array(json.dumps(BLOCK_PLACEMENTS)),
             meshes=np.array(json.dumps(MESHES)),
             gpt_kw=np.array(json.dumps(gpt_kw)), gpt_ids=ids,
             gpt_labels=labels,
             **{f"block/{k}": v for k, v in block_state.items()},
             **{f"gpt/{k}": v for k, v in gpt_state.items()})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("auto_parallel")
    ref = _jax_reference(d)
    logs = run_ranks(d, _WORKER, {"dp_degree": NPROC}, nproc=NPROC,
                     timeout=240)
    port = dict(np.load(d / "port.npz"))
    return ref, port, logs


@pytest.mark.parametrize("check", [
    "process_mesh", "shard_tensor", "reshard_changes_placement",
    "shard_layer_default_replicates", "predict_single_field",
    "reshard_moves", "save_load"])
def test_reference_cases_on_four_ranks(ranks, check):
    assert_check(ranks[2], check, NPROC)


def _port_names(port, prefix):
    return sorted(k[len(prefix):] for k in port if k.startswith(prefix))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_engine_first_step_matches_jax(ranks, mesh):
    """The first step's global loss (every rank's) and every gathered
    gradient within 1e-5 of the JAX package's."""
    ref, port, logs = ranks
    assert_check(logs, "engine_tp", NPROC)
    # each rank's loss is its rows' mean; the global one is their mean
    # over the batch's mesh dim (dp in the 2 x 2 mesh: ranks 0, 2)
    losses = port[f"{mesh}/loss_ranks"]
    rows = losses if mesh == "mp4" else losses[[0, 2]]
    assert abs(rows.mean() - ref["block_loss"]) <= TOL * abs(
        ref["block_loss"])
    names = _port_names(port, f"{mesh}/grad/")
    assert names == sorted(ref["block_grads"])
    for n in names:
        assert rel_err(port[f"{mesh}/grad/{n}"], ref["block_grads"][n]) \
            <= TOL, n


@pytest.mark.parametrize("mesh", list(MESHES))
def test_engine_history_matches_jax(ranks, mesh):
    """The two-epoch history, bit-equal across the ranks (the worker
    checks), within 2e-4 relative of the JAX Engine's on the same mesh."""
    ref, port, _ = ranks
    np.testing.assert_allclose(port[f"{mesh}/hist"], ref[f"{mesh}/hist"],
                               rtol=2e-4)


@pytest.mark.parametrize("fault", ["grad2", "grad0"])
def test_a_second_average_or_none_fails_the_bound(ranks, fault):
    """A gradient averaged twice over the batch's mesh dim (grad2), or
    not averaged (grad0), misses the JAX gradients by far more than 1e-5:
    the first-step check would catch either."""
    ref, port, _ = ranks
    worst = max(rel_err(port[f"mp4/{fault}/{n}"], ref["block_grads"][n])
                for n in ref["block_grads"])
    assert worst > 100 * TOL


def test_engine_tied_gpt_matches_jax_engine(ranks):
    """GPT with its tied wte placed Shard(0) (one leaf, both uses): the
    first step's loss against the JAX Engine's, the gradients against the
    JAX package's on the whole batch, the updated parameters against the
    JAX Engine's (the AdamW first-step rule, ``param_rule_err``, on the
    clipped gradients, entries with |g| < 1e-6 masked), each within
    1e-5."""
    ref, port, logs = ranks
    assert_check(logs, "engine_gpt_tied", NPROC)
    assert abs(float(port["gpt/loss"]) - ref["gpt_loss"]) <= TOL * abs(
        ref["gpt_loss"])
    from paddle_tpu_torch.convert import gpt_state_from_jax
    grads = gpt_state_from_jax(ref["gpt_grads"])
    params = gpt_state_from_jax(ref["gpt_params"])
    names = _port_names(port, "gpt/grad/")
    assert names == sorted(grads)
    # the update read the gradients after ClipGradByGlobalNorm(1.0); where
    # |g| < 1e-6 (the k bias's, zero but for rounding) the first AdamW step
    # hangs on digits fp32 leaves open, so those entries are masked, as
    # the data-parallel GPT comparison masks them
    norm = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                       for g in grads.values()))
    clip = min(1.0, 1.0 / norm)
    for n in names:
        assert rel_err(port[f"gpt/grad/{n}"], grads[n]) <= TOL, n
        keep = np.abs(grads[n]) >= 1e-6
        assert param_rule_err(port[f"gpt/param/{n}"][keep],
                              params[n][keep],
                              clip * port[f"gpt/grad/{n}"][keep],
                              clip * grads[n][keep]) <= TOL, n


def test_partial_refused_as_in_the_reference():
    import torch

    import paddle_tpu_torch.distributed as dist
    mesh = dist.ProcessMesh([0], dim_names=["x"])
    t = torch.ones(2, 2)
    with pytest.raises(NotImplementedError, match="Partial"):
        dist.shard_tensor(t, mesh, [dist.Partial()])
    placed = dist.shard_tensor(t, mesh, [dist.Replicate()])
    with pytest.raises(NotImplementedError, match="Partial"):
        dist.reshard(placed, mesh, [dist.Partial()])
    with pytest.raises(NotImplementedError, match="only 'sum'"):
        dist.Partial("max")


def test_placement_predicates():
    import paddle_tpu_torch.distributed as dist
    assert dist.Shard(0).is_shard() and dist.Shard(1).is_shard(1)
    assert not dist.Shard(1).is_shard(0)
    assert dist.Replicate().is_replicated()
    assert dist.Partial().is_partial()
    assert dist.Shard(0) == dist.Shard(0) != dist.Shard(1)
    assert repr(dist.Shard(2)) == "Shard(dim=2)"
    mesh = dist.ProcessMesh([0], dim_names=["x"])
    assert dist.DistAttr(mesh, ["x", None]).placements() == [dist.Shard(0)]


def test_one_process_engine_matches_plain_adamw():
    """Without a mesh the Engine is one process's training loop: its
    parameters after a step equal a plain AdamW step's bit for bit."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import AdamW

    def build():
        torch.manual_seed(0)
        net = nn.Linear(4, 3, device="cpu")
        return net, AdamW(learning_rate=1e-2, parameters=net.parameters())

    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(1))
    y = torch.randn(6, 3, generator=torch.Generator().manual_seed(2))
    mse = lambda o, t: torch.mean(torch.square(o - t))  # noqa: E731
    net, opt = build()
    hist = dist.Engine(net, loss=mse, optimizer=opt).fit([(x, y)])
    ref, ropt = build()
    loss = mse(ref(x), y)
    loss.backward()
    ropt.step()
    assert hist["loss"] == [float(loss.detach())]
    for a, b in zip(net.parameters(), ref.parameters()):
        assert torch.equal(a, b)
