"""Tensor parallelism of the port (``fleet/meta_parallel/{mp_layers,
random}.py``, ``text/gpt.py`` under ``tensor_parallel``, ``convert.
slice_gpt_state``, ``CompiledTrainStep``'s sync and clip) at mp 2: two
gloo ranks on the CPU, launched once for the file, against the JAX
package in this process.

- Each mp layer (column with and without ``gather_output``, row with
  and without ``input_is_parallel``, the vocab embedding) on its rank's
  piece of the reference layer's full weights: output, input gradient and
  the gathered weight and bias gradients equal the JAX layer's.
- ``ParallelCrossEntropy`` on vocab-split logits with ``ignore_index``
  rows: the reference's ``F.cross_entropy(reduction="none")`` of the
  whole logits, and its gradient.
- The TP GPT step: the JAX package's TP GPT (``tensor_parallel=True``)
  on its mp-2 mesh and the port's ranks, loaded through
  ``slice_gpt_state`` from its weights, one AdamW step on the same batch:
  the loss, every gathered gradient and every updated parameter (PR 14's
  AdamW first-step rule, against the reference's eager AdamW step from
  the gradients it used), and the two losses of the reference's compiled
  step. The hybrid clip's
  scale equals ``ClipGradByGlobalNorm``'s on the whole gradients.
- The per-head qkv split: ``slice_gpt_state`` keeps heads [r*nh/mp,
  (r+1)*nh/mp) of each of q, k and v; a contiguous column split of the
  packed qkv gives another loss (so the step test fails on it).
- The old world-wide gradient average gives a wrong TP step.
- The RNG tracker: ``local_seed`` differs across the mp ranks,
  ``global_seed`` and ``model_parallel_rng`` agree, and a tracked state
  leaves the outer state as it was.

Tolerances, fp32: the loss within 1e-5 of itself; each gradient and
parameter within 1e-5 of its largest entry.
"""
import os

import numpy as np
import pytest

from _torch_hybrid_helpers import (GPT_KW, assert_check, gpt_reference,
                                   param_rule_err, rel_err, run_ranks,
                                   save_npz)

TOL = 1e-5
LAYER_CASES = ("column_gather", "column_split", "row_whole", "row_parallel",
               "vocab")

_WORKER = """
from paddle_tpu_torch.convert import load_jax_state, slice_gpt_state
from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
    hybrid_clip)
from paddle_tpu_torch.distributed.parallel import all_reduce_gradients
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining

MP = MESH.coord["mp"]
L = np.load(f"{DATA}/layers.npz")
out = {}


def load_piece(p, full):
    with torch.no_grad():
        p.copy_(torch.from_numpy(placement_of(p).take(full)))


def layer_case(name, layer, x, split_out=False, split_in=False):
    load_piece(layer.weight, L[f"{name}/w"])
    if getattr(layer, "bias", None) is not None:
        load_piece(layer.bias, L[f"{name}/b"])
    xin = x
    if split_in:
        xin = x.chunk(2, dim=-1)[MP]
    xin = xin.clone().requires_grad_(xin.is_floating_point())
    y = layer(xin)
    cot = torch.from_numpy(L[f"{name}/cot"])
    if split_out:
        cot = cot.chunk(2, dim=-1)[MP]
    (y * cot).sum().backward()
    got = {"y": y, "w": gather_global(layer.weight.grad,
                                      placement_of(layer.weight))}
    if xin.requires_grad:
        got["dx"] = xin.grad
    if getattr(layer, "bias", None) is not None:
        got["b"] = gather_global(layer.bias.grad, placement_of(layer.bias))
    for k, v in got.items():
        out[f"{name}/{k}/{RANK}"] = v.detach().numpy()


x = torch.from_numpy(L["x"])
layer_case("column_gather", mpar.ColumnParallelLinear(
    16, 24, gather_output=True, device="cpu"), x)
layer_case("column_split", mpar.ColumnParallelLinear(
    16, 24, gather_output=False, device="cpu"), x, split_out=True)
xr = torch.from_numpy(L["xr"])
layer_case("row_whole", mpar.RowParallelLinear(
    24, 16, input_is_parallel=False, device="cpu"), xr)
layer_case("row_parallel", mpar.RowParallelLinear(
    24, 16, input_is_parallel=True, device="cpu"), xr, split_in=True)
layer_case("vocab", mpar.VocabParallelEmbedding(20, 8, device="cpu"),
           torch.from_numpy(L["ids"]))
ok("layers")

# the vocab-parallel cross-entropy
logits = torch.from_numpy(L["ce/logits"]).chunk(2, dim=-1)[MP]
logits = logits.clone().requires_grad_(True)
loss = mpar.ParallelCrossEntropy()(logits, torch.from_numpy(L["ce/labels"]))
(loss * torch.from_numpy(L["ce/cot"])).sum().backward()
out[f"ce/loss/{RANK}"] = loss.detach().numpy()
out[f"ce/grad/{RANK}"] = logits.grad.numpy()
ok("ce")

# the TP GPT step
G = np.load(f"{DATA}/gpt.npz")
state = {k[6:]: G[k] for k in G.files if k.startswith("state/")}
ids, labels = torch.from_numpy(G["ids"]), torch.from_numpy(G["labels"])
KW = json.loads(str(G["kw"]))


def tp_model(pieces):
    m = GPTForPretraining(GPTConfig(tensor_parallel=True, **KW),
                          device="cpu")
    load_jax_state(m, pieces)
    return m


def step_of(m, sync=None):
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    step = CompiledTrainStep(lambda a, b: m(a, labels=b)[1], m, opt)
    real = sync or step._sync
    seen = {}

    def spy(grads):
        seen["grads"] = real(grads)
        return seen["grads"]

    step._sync = spy
    return step, seen


m = tp_model(slice_gpt_state(state, 2, MP))
step, seen = step_of(m)
out["gpt/loss1"] = np.float64(step(ids, labels))
params = list(m.named_parameters())
for (n, p), g in zip(params, seen["grads"]):
    out[f"gpt/grad/{n}"] = gather_global(g, placement_of(p)).numpy()
for n, p in params:
    out[f"gpt/param/{n}"] = gather_global(p).numpy()
clipped = hybrid_clip(ClipGradByGlobalNorm(0.1), [p for _, p in params],
                      seen["grads"], MESH)
i = max(range(len(params)), key=lambda j: float(seen["grads"][j].abs().max()))
out["gpt/clip_scale"] = float((clipped[i] / seen["grads"][i]).flatten()[
    seen["grads"][i].abs().flatten().argmax()])
out["gpt/loss2"] = np.float64(step(ids, labels))
ok("gpt")

# a contiguous column split of the packed qkv (the trap)
pieces = slice_gpt_state(state, 2, MP)
for n in pieces:
    if "qkv_proj" in n:
        whole = state[n]
        w = whole.shape[-1] // 2
        pieces[n] = np.ascontiguousarray(whole[..., MP * w:(MP + 1) * w])
out["contiguous/loss"] = float(tp_model(pieces)(ids, labels=labels)[1])
ok("contiguous")

# the old rule: gradients averaged over the whole world (here: mp)
m = tp_model(slice_gpt_state(state, 2, MP))
step, seen = step_of(m, sync=lambda grads: all_reduce_gradients(grads))
step(ids, labels)
for (n, p), g in zip(m.named_parameters(), seen["grads"]):
    out[f"world/grad/{n}"] = gather_global(g, placement_of(p)).numpy()
ok("world")

# the RNG tracker
mpar.model_parallel_random_seed(1234)
tracker = mpar.get_rng_state_tracker()
outer = torch.get_rng_state()
draws = {}
for name in ("local_seed", "global_seed", "model_parallel_rng"):
    with tracker.rng_state(name):
        draws[name] = torch.rand(6).tolist() + \\
            torch.nn.functional.dropout(torch.ones(16), 0.5).tolist()
assert torch.equal(outer, torch.get_rng_state())
with tracker.rng_state("local_seed"):
    again = torch.rand(6).tolist()
assert again != draws["local_seed"][:6]   # the state moved on
seen_draws = []
dist.all_gather_object(seen_draws, draws)
assert seen_draws[0]["local_seed"] != seen_draws[1]["local_seed"]
assert seen_draws[0]["global_seed"] == seen_draws[1]["global_seed"]
assert seen_draws[0]["model_parallel_rng"] == \\
    seen_draws[1]["model_parallel_rng"]
ok("rng")

rows = []
dist.all_gather_object(rows, {k: v for k, v in out.items()
                              if k.endswith(f"/{RANK}")})
if RANK == 0:
    for r in rows:
        out.update(r)
    np.savez(f"{DATA}/port.npz", **out)
ok("saved")
"""


def _layers_ref(d):
    """The JAX mp layers (dense on one device) on full weights."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet import meta_parallel as jmp
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    data = {"x": f32(3, 5, 16), "xr": f32(3, 5, 24),
            "ids": rng.integers(0, 20, (3, 5)).astype(np.int64)}
    cases = {"column_gather": (jmp.ColumnParallelLinear(16, 24), "x", 24),
             "column_split": (jmp.ColumnParallelLinear(
                 16, 24, gather_output=False), "x", 24),
             "row_whole": (jmp.RowParallelLinear(24, 16), "xr", 16),
             "row_parallel": (jmp.RowParallelLinear(
                 24, 16, input_is_parallel=True), "xr", 16),
             "vocab": (jmp.VocabParallelEmbedding(20, 8), "ids", 8)}
    for name, (layer, xin, width) in cases.items():
        w = f32(*layer.weight.shape)
        sd = {"weight": w}
        data[f"{name}/w"] = w
        if getattr(layer, "bias", None) is not None:
            data[f"{name}/b"] = sd["bias"] = f32(*layer.bias.shape)
        layer.set_state_dict(sd)
        cot = f32(3, 5, width)
        data[f"{name}/cot"] = cot
        x = paddle.to_tensor(data[xin], stop_gradient=xin == "ids")
        y = layer(x)
        (y * paddle.to_tensor(cot)).sum().backward()
        data[f"{name}/ref/y"] = np.asarray(y._value)
        data[f"{name}/ref/w"] = np.asarray(layer.weight.grad._value)
        if xin != "ids":
            data[f"{name}/ref/dx"] = np.asarray(x.grad._value)
        if getattr(layer, "bias", None) is not None:
            data[f"{name}/ref/b"] = np.asarray(layer.bias.grad._value)
    logits = f32(2, 3, 20)
    labels = rng.integers(0, 20, (2, 3)).astype(np.int64)
    labels[0, 1] = labels[1, 2] = -100
    cot = f32(2, 3)
    lt = paddle.to_tensor(logits, stop_gradient=False)
    loss = paddle.nn.functional.cross_entropy(
        lt, paddle.to_tensor(labels), reduction="none", ignore_index=-100)
    (loss * paddle.to_tensor(cot)).sum().backward()
    data.update({"ce/logits": logits, "ce/labels": labels, "ce/cot": cot,
                 "ce/ref/loss": np.asarray(loss._value),
                 "ce/ref/grad": np.asarray(lt.grad._value)})
    save_npz(d / "layers.npz", **data)
    return data


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_parallel")
    old = os.environ.get("PDTPU_PALLAS_INTERPRET")
    os.environ["PDTPU_PALLAS_INTERPRET"] = "0"   # the JAX dense attention
    try:
        layers = _layers_ref(d)
        gpt = gpt_reference(d)
    finally:
        if old is None:
            os.environ.pop("PDTPU_PALLAS_INTERPRET", None)
        else:
            os.environ["PDTPU_PALLAS_INTERPRET"] = old
    logs = run_ranks(d, _WORKER, {"dp_degree": 1, "mp_degree": 2})
    port = dict(np.load(d / "port.npz"))
    return {"logs": logs, "layers": layers, "gpt": gpt, "port": port}


@pytest.mark.parametrize("case", LAYER_CASES)
def test_mp_layer_matches_jax(run, case):
    assert_check(run["logs"], "layers")
    ref, port = run["layers"], run["port"]
    for r in range(2):
        for k in ("y", "dx", "w", "b"):
            want = ref.get(f"{case}/ref/{k}")
            if want is None:
                continue
            got = port[f"{case}/{k}/{r}"]
            if case == "column_split" and k == "y":
                want = np.split(want, 2, axis=-1)[r]
            if case == "row_parallel" and k == "dx":
                want = np.split(want, 2, axis=-1)[r]
            assert got.shape == want.shape, (case, k)
            assert rel_err(got, want) <= TOL, (case, k, rel_err(got, want))


def test_parallel_cross_entropy_matches_jax(run):
    assert_check(run["logs"], "ce")
    ref, port = run["layers"], run["port"]
    for r in range(2):
        loss = port[f"ce/loss/{r}"]
        assert loss.shape == ref["ce/ref/loss"].shape
        assert loss[0, 1] == 0 and loss[1, 2] == 0     # ignored rows
        assert rel_err(loss, ref["ce/ref/loss"]) <= TOL
        want = np.split(ref["ce/ref/grad"], 2, axis=-1)[r]
        assert rel_err(port[f"ce/grad/{r}"], want) <= TOL


def test_tp_gpt_step_matches_jax(run):
    assert_check(run["logs"], "gpt")
    gpt, port = run["gpt"], run["port"]
    assert abs(port["gpt/loss1"] - gpt["loss1"]) <= TOL * abs(gpt["loss1"])
    assert abs(port["gpt/loss2"] - gpt["loss2"]) <= TOL * abs(gpt["loss2"])
    assert gpt["loss2"] < gpt["loss1"]
    for n, want in gpt["grads"].items():
        got = port[f"gpt/grad/{n}"]
        assert got.shape == want.shape, n
        assert rel_err(got, want) <= TOL, (n, rel_err(got, want))
    for n, want in gpt["params"].items():
        err = param_rule_err(port[f"gpt/param/{n}"], want,
                             port[f"gpt/grad/{n}"], gpt["grads"][n])
        assert err <= TOL, (n, err)


def test_hybrid_clip_scale_equals_one_process(run):
    grads = run["gpt"]["grads"]
    norm = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                       for g in grads.values()))
    want = min(0.1 / norm, 1.0)
    assert want < 1.0
    assert abs(run["port"]["gpt/clip_scale"] - want) <= TOL * want


def test_qkv_split_is_per_head():
    from paddle_tpu_torch.convert import slice_gpt_state
    h, nh = GPT_KW["hidden_size"], GPT_KW["num_heads"]
    hd = h // nh
    w = np.arange(h * 3 * h, dtype=np.float32).reshape(h, 3 * h)
    state = {"gpt.blocks.0.attn.qkv_proj.weight": w}
    for r in range(2):
        got = slice_gpt_state(state, 2, r)["gpt.blocks.0.attn.qkv_proj.weight"]
        heads = range(r * nh // 2, (r + 1) * nh // 2)
        cols = [part * h + head * hd + j for part in range(3)
                for head in heads for j in range(hd)]
        np.testing.assert_array_equal(got, w[:, cols])
        contiguous = np.split(w, 2, axis=1)[r]
        assert got.shape == contiguous.shape
        assert not np.array_equal(got, contiguous)


def test_contiguous_qkv_split_gives_another_loss(run):
    assert_check(run["logs"], "contiguous")
    assert abs(run["port"]["contiguous/loss"] - run["gpt"]["loss0"]) > 1e-3
    assert abs(run["gpt"]["loss0"] - run["gpt"]["loss1"]) <= \
        TOL * run["gpt"]["loss1"]


def test_world_average_gives_a_wrong_tp_step(run):
    assert_check(run["logs"], "world")
    worst = max(rel_err(run["port"][f"world/grad/{n}"], want)
                for n, want in run["gpt"]["grads"].items())
    assert worst > 1e-2, worst


def test_rng_tracker_properties(run):
    assert_check(run["logs"], "rng")
