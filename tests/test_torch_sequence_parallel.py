"""Sequence parallelism of the port (``fleet/utils/
sequence_parallel_utils.py``, ``text/gpt.py`` under
``sequence_parallel``) at mp 2: two gloo ranks on the CPU, launched once
for the file, against the JAX package in this process.

- The SP block (the port's counterpart of
  ``tests/test_sequence_parallel.py:46,110``): scatter the sequence, a
  LayerNorm on the rank's rows, ``ColumnSequenceParallelLinear``, exact
  GELU, ``RowSequenceParallelLinear``, gather; output and every gathered
  gradient against the JAX package's layers on the same weights (dense
  in eager), and the input's gradient.
- The LayerNorm-gradient hook: with the LayerNorm marked and
  ``register_sequence_parallel_allreduce_hooks``, its gradients are the
  whole sequence's; without the hook, each rank's differ (its rows only).
  The reference's hook is a no-op (GSPMD reduces them): the port's is
  real (ROADMAP C).
- ``ScatterOp``/``GatherOp``/``AllGatherOp``/``ReduceScatterOp``: the
  round trip is the identity, and each pair's backward is the other's
  forward.
- The SP GPT (``sequence_parallel=True``) loaded through
  ``slice_gpt_state``: the step's loss and every gathered gradient
  against the JAX package's TP GPT on its mp-2 mesh.

Tolerances, fp32: the loss within 1e-5 of itself; each output and
gradient within 1e-5 of its largest entry.
"""
import numpy as np
import pytest

from _torch_hybrid_helpers import (assert_check, gpt_reference, rel_err,
                                   run_ranks, save_npz)

TOL = 1e-5
B, S, H, FF = 2, 8, 16, 32

_WORKER = """
from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import load_jax_state, slice_gpt_state
from paddle_tpu_torch.distributed.fleet.utils import \\
    sequence_parallel_utils as spu
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining

MP = MESH.coord["mp"]
L = np.load(f"{DATA}/block.npz")
out = {}


def block(hooks):
    ln = nn.LayerNorm(16, device="cpu")
    col = spu.ColumnSequenceParallelLinear(16, 32, device="cpu")
    row = spu.RowSequenceParallelLinear(32, 16, device="cpu")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(L["ln/w"]))
        ln.bias.copy_(torch.from_numpy(L["ln/b"]))
        for p, k in ((col.weight, "col/w"), (col.bias, "col/b"),
                     (row.weight, "row/w"), (row.bias, "row/b")):
            p.copy_(torch.from_numpy(placement_of(p).take(L[k])))
    net = torch.nn.ModuleList([ln, col, row])
    for p in ln.parameters():
        spu.mark_as_sequence_parallel_parameter(p)
    if hooks:
        spu.register_sequence_parallel_allreduce_hooks(net)
    x = torch.from_numpy(L["x"]).requires_grad_(True)
    t = ln(spu.ScatterOp.apply(x))
    y = spu.GatherOp.apply(row(F.gelu(col(t), approximate=False)))
    (y * torch.from_numpy(L["cot"])).sum().backward()
    got = {"y": y.detach(), "dx": x.grad,
           "ln/w": ln.weight.grad, "ln/b": ln.bias.grad,
           "col/w": gather_global(col.weight.grad, placement_of(col.weight)),
           "col/b": gather_global(col.bias.grad, placement_of(col.bias)),
           "row/w": gather_global(row.weight.grad, placement_of(row.weight)),
           "row/b": row.bias.grad}
    return {k: v.numpy() for k, v in got.items()}


for k, v in block(True).items():
    out[f"hooked/{k}/{RANK}"] = v
for k, v in block(False).items():
    out[f"bare/{k}/{RANK}"] = v
ok("block")

# the ops: round trips and adjoints
x = torch.from_numpy(L["x"]).requires_grad_(True)
assert torch.equal(spu.GatherOp.apply(spu.ScatterOp.apply(x)), x)
assert torch.equal(spu.AllGatherOp.apply(spu.ScatterOp.apply(x)), x)
g = torch.from_numpy(L["cot"])
(spu.GatherOp.apply(spu.ScatterOp.apply(x)) * g).sum().backward()
assert torch.equal(x.grad, g)
part = x.detach().chunk(2, dim=1)[MP].clone().requires_grad_(True)
full = spu.AllGatherOp.apply(part)
(full * g).sum().backward()     # reduce-scatter: the ranks' sum of g rows
assert torch.equal(part.grad, 2 * g.chunk(2, dim=1)[MP])
whole = x.detach().clone().requires_grad_(True)
rs = spu.ReduceScatterOp.apply(whole)
assert torch.equal(rs, 2 * x.detach().chunk(2, dim=1)[MP])
(rs * g.chunk(2, dim=1)[MP]).sum().backward()   # all-gather
assert torch.equal(whole.grad, g)
ok("ops")

# the SP GPT step
G = np.load(f"{DATA}/gpt.npz")
state = {k[6:]: G[k] for k in G.files if k.startswith("state/")}
ids, labels = torch.from_numpy(G["ids"]), torch.from_numpy(G["labels"])
KW = json.loads(str(G["kw"]))
m = GPTForPretraining(GPTConfig(sequence_parallel=True, **KW), device="cpu")
load_jax_state(m, slice_gpt_state(state, 2, MP))
step = CompiledTrainStep(lambda a, b: m(a, labels=b)[1], m,
                         SGD(learning_rate=0.0, parameters=m.parameters()))
seen = {}
real = step._sync
step._sync = lambda grads: seen.setdefault("g", real(grads))
out["gpt/loss"] = float(step(ids, labels))
for (n, p), g in zip(m.named_parameters(), seen["g"]):
    out[f"gpt/grad/{n}"] = gather_global(g, placement_of(p)).numpy()
ok("gpt")

rows = []
dist.all_gather_object(rows, {k: v for k, v in out.items()
                              if k.endswith(f"/{RANK}")})
if RANK == 0:
    for r in rows:
        out.update(r)
    np.savez(f"{DATA}/port.npz", **out)
ok("saved")
"""


def _block_reference(d):
    """The JAX package's SP layers (dense in eager) with a LayerNorm in
    front, on seeded weights."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.utils.sequence_parallel_utils import (
        ColumnSequenceParallelLinear, RowSequenceParallelLinear)
    rng = np.random.default_rng(11)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    data = {"x": f32(B, S, H), "cot": f32(B, S, H),
            "ln/w": 1 + 0.1 * f32(H), "ln/b": 0.1 * f32(H),
            "col/w": f32(H, FF) / 4, "col/b": f32(FF) / 4,
            "row/w": f32(FF, H) / 6, "row/b": f32(H) / 4}
    ln = paddle.nn.LayerNorm(H)
    col = ColumnSequenceParallelLinear(H, FF, has_bias=True)
    row = RowSequenceParallelLinear(FF, H, has_bias=True)
    ln.set_state_dict({"weight": data["ln/w"], "bias": data["ln/b"]})
    col.set_state_dict({"weight": data["col/w"], "bias": data["col/b"]})
    row.set_state_dict({"weight": data["row/w"], "bias": data["row/b"]})
    x = paddle.to_tensor(data["x"], stop_gradient=False)
    y = row(paddle.nn.functional.gelu(col(ln(x)), approximate=False))
    (y * paddle.to_tensor(data["cot"])).sum().backward()
    ref = {"y": y, "dx": x.grad, "ln/w": ln.weight.grad,
           "ln/b": ln.bias.grad, "col/w": col.weight.grad,
           "col/b": col.bias.grad, "row/w": row.weight.grad,
           "row/b": row.bias.grad}
    save_npz(d / "block.npz", **data)
    return {k: np.asarray(v._value) for k, v in ref.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import os
    d = tmp_path_factory.mktemp("sequence_parallel")
    old = os.environ.get("PDTPU_PALLAS_INTERPRET")
    os.environ["PDTPU_PALLAS_INTERPRET"] = "0"
    try:
        block = _block_reference(d)
        gpt = gpt_reference(d)
    finally:
        if old is None:
            os.environ.pop("PDTPU_PALLAS_INTERPRET", None)
        else:
            os.environ["PDTPU_PALLAS_INTERPRET"] = old
    logs = run_ranks(d, _WORKER, {"dp_degree": 1, "mp_degree": 2})
    return {"logs": logs, "block": block, "gpt": gpt,
            "port": dict(np.load(d / "port.npz"))}


@pytest.mark.parametrize("name", ["y", "dx", "ln/w", "ln/b", "col/w",
                                  "col/b", "row/w", "row/b"])
def test_sp_block_matches_jax(run, name):
    assert_check(run["logs"], "block")
    for r in range(2):
        got, want = run["port"][f"hooked/{name}/{r}"], run["block"][name]
        assert got.shape == want.shape
        assert rel_err(got, want) <= TOL, (name, r, rel_err(got, want))


def test_layer_norm_hook_sums_the_ranks_rows(run):
    port = run["port"]
    for name in ("ln/w", "ln/b"):
        bare = [port[f"bare/{name}/{r}"] for r in range(2)]
        assert rel_err(bare[0], run["block"][name]) > 1e-2
        assert rel_err(bare[0] + bare[1], run["block"][name]) <= TOL


def test_scatter_gather_ops(run):
    assert_check(run["logs"], "ops")


def test_sp_gpt_step_matches_jax(run):
    assert_check(run["logs"], "gpt")
    gpt, port = run["gpt"], run["port"]
    assert abs(port["gpt/loss"] - gpt["loss0"]) <= TOL * gpt["loss0"]
    for n, want in gpt["grads"].items():
        got = port[f"gpt/grad/{n}"]
        assert got.shape == want.shape, n
        assert rel_err(got, want) <= TOL, (n, rel_err(got, want))
