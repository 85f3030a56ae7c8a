"""The port's in-program quantized collectives, the quantized ZeRO-3
gather, ``dcn_grad_sync`` and the ``comm_quant`` strategy field
(``paddle_tpu_torch/distributed/{comm_quant,sharding_api}.py``,
``fleet/meta_parallel/sharding.py``, ``fleet/fleet_facade.py``) against
the JAX package's ``shard_map`` programs on the pytest session's virtual CPU
devices.

Four gloo ranks on the CPU, launched once for the file; each rank runs
every form on its own value over a mesh axis's group and saves its
result:

- ``quantized_all_reduce`` "sum" and "mean" on 999 elements (not a
  multiple of the block) over a dp axis of 4 and of 2 (dp 2 x mp 2), at
  int8 with fp32 scales, int8 with bf16 scales and blocks of 128, and
  fp8 e4m3: bit-equal to the reference's two-phase ring under
  ``shard_map``, and the same on every rank;
- ``quantized_all_gather`` at 4 and 2: bit-equal;
- ``hierarchical_all_reduce`` at dcn 2 x dp 2, "sum" and "mean", and
  ``dcn_grad_sync`` there, fp32 and int8, "sum" and "mean", at once and
  with ``async_op``: bit-equal to the reference's
  (``tests/test_comm_quant.py:118-212``); without a dcn axis it returns
  the value;
- ``GroupShardedStage3.get_all_parameters`` at sharding 2 (a Linear's
  [64, 32] weight and [32] bias, a LayerNorm's [768] weight and bias:
  1.5 blocks a rank, so a block straddles the ranks) in the reference's
  order (``tests/test_comm_quant.py:434-466``): ``quant=False`` with a
  config active bit-equal to the whole state, then re-sharded and
  gathered through the active config, bit-equal to the reference's
  ``quantized_replicate`` of the whole value, with fp32 and with bf16
  scales, and equal on both ranks;
- the quantized data-parallel step with ``ErrorFeedback``
  (``DataParallel(comm_quant=...)`` over a group of two): the synced
  gradients equal on both ranks and within two wire crossings of the
  exact mean (max |g| / 127), the residual that of the compensated
  gradient, the second step compensated by it; and ``fleet.init`` with
  ``comm_quant`` set, whose ``distributed_model`` syncs quantized.

In one process: the codec's ``traced`` arithmetic is the reference's
compiled one, and the forms refuse ops other than sum and mean.
"""
import json

import numpy as np
import pytest
import torch

from _torch_hybrid_helpers import assert_check, run_ranks, save_npz

N_AR = 999
CFGS = {"int8": {},
        "int8_bf16_128": {"scale_dtype": "bfloat16", "block_size": 128},
        "fp8": {"dtype": "fp8_e4m3", "scale_dtype": "bfloat16"}}

_WORKER = """
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import comm_quant as cq
from paddle_tpu_torch.distributed.parallel import DataParallel
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.distributed.sharding_api import (build_mesh,
                                                       dcn_grad_sync,
                                                       set_default_mesh)
from paddle_tpu_torch.optimizer import AdamW

D = np.load(f"{DATA}/inputs.npz")
CFGS = {k: cq.QuantConfig(**v) for k, v in json.loads(str(D["cfgs"])).items()}
out = {}
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731

# the ring and the gather over a dp axis of 4, then of 2 (dp 2 x mp 2)
mesh4 = build_mesh(dp=4)
mesh2 = build_mesh(dp=2, mp=2)
for n, mesh in ((4, mesh4), (2, mesh2)):
    set_default_mesh(mesh)
    me = mesh.coord["dp"]
    for name, cfg in CFGS.items():
        if n == 4 and name != "int8":
            continue
        x = t(D[f"ar/{n}"][me])
        out[f"ar/{n}/{name}/sum/{RANK}"] = cq.quantized_all_reduce(
            x, "dp", cfg, op="sum").numpy()
        out[f"ag/{n}/{name}/{RANK}"] = cq.quantized_all_gather(
            x[:130], "dp", cfg).numpy()
    out[f"ar/{n}/int8/mean/{RANK}"] = cq.quantized_all_reduce(
        t(D[f"ar/{n}"][me]), "dp", op="mean").numpy()
ok("ring")

# DCN: the hierarchical all-reduce and dcn_grad_sync at dcn 2 x dp 2
mesh = set_default_mesh(build_mesh(dp=2, dcn_dp=2))
c = mesh.coord
x = t(D["hier"][c["dcn"], c["dp"]])
for op in ("sum", "mean"):
    out[f"hier/{op}/{RANK}"] = cq.hierarchical_all_reduce(
        x, "dp", "dcn", CFGS["int8"], op=op).numpy()
g = t(D["dcn"][c["dcn"]])
for quant in ("fp32", "int8"):
    cfg = None if quant == "fp32" else CFGS["int8"]
    for op in ("sum", "mean"):
        out[f"dcn/{quant}/{op}/{RANK}"] = dcn_grad_sync(
            g, mesh, quant=cfg, op=op).numpy()
    work = dcn_grad_sync(g, mesh, quant=cfg, async_op=True)
    out[f"dcn/{quant}/async/{RANK}"] = work.result().numpy()
for async_op in (False, True):
    same = dcn_grad_sync(g, mesh4, async_op=async_op)
    same = same.result() if async_op else same
    assert same is g
ok("dcn")

# the quantized ZeRO-3 gather at sharding 2
set_default_mesh(build_mesh(dp=2, sharding=2))
net = torch.nn.Sequential(nn.Linear(64, 32, device="cpu"),
                          nn.LayerNorm(768, device="cpu"))
with torch.no_grad():
    for n_, p in net.named_parameters():
        p.copy_(t(D["zero/" + n_]))
model, _, _ = group_sharded_parallel(
    net, AdamW(parameters=net.parameters()), "p_g_os")
assert all(p.shape[0] == D["zero/" + n_].shape[0] // 2
           for n_, p in net.named_parameters())
cq.set_active_config(CFGS["int8"])
model.get_all_parameters(quant=False)
for n_, p in net.named_parameters():
    out[f"zero/exact/{n_}/{RANK}"] = p.detach().numpy().copy()
for name in ("int8", "int8_bf16_128"):
    cq.set_active_config(CFGS[name])
    model._shard_params()
    cq.reset_stats()
    model.get_all_parameters()
    out[f"zero/bytes/{name}/{RANK}"] = np.array(cq.stats()["bytes"])
    for n_, p in net.named_parameters():
        out[f"zero/{name}/{n_}/{RANK}"] = p.detach().numpy().copy()
        with torch.no_grad():
            p.copy_(t(D["zero/" + n_]))
cq.set_active_config(None)
ok("zero3")

# the quantized data-parallel step with error feedback, over dp 2
set_default_mesh(mesh2)
group = mesh2.group("dp")
cfg = cq.QuantConfig(error_feedback=True)
lin = nn.Linear(300, 4, device="cpu")
with torch.no_grad():
    lin.weight.copy_(t(D["dp/w"]))
    lin.bias.zero_()
dp = DataParallel(lin, group=group, comm_quant=cfg)
xs = t(D["dp/x"][mesh2.coord["dp"]])
resid = {}
for step in range(2):
    local = torch.autograd.grad((lin(xs * (step + 1)) ** 2).mean(),
                                lin.weight)[0]
    lin.weight.grad = None
    lin.bias.grad = None
    (dp(xs * (step + 1)) ** 2).mean().backward()
    out[f"dp/{step}/local/{RANK}"] = local.numpy()
    out[f"dp/{step}/synced/{RANK}"] = lin.weight.grad.numpy().copy()
    ef = dp._error_feedback
    key = [k for k in ef._resid if k.endswith("weight")][0]
    want = local + resid.get(key, 0.0)
    out[f"dp/{step}/compensated/{RANK}"] = want.numpy()
    torch.testing.assert_close(ef._resid[key],
                               want - cq.quantization_roundtrip(want, cfg),
                               rtol=0, atol=0)
    resid[key] = ef._resid[key].clone()
assert dp._quant_sync_count == 2
ok("dp_quant")

# fleet.init with comm_quant: distributed_model syncs quantized
strategy = fleet.DistributedStrategy()
strategy.hybrid_configs = {"dp_degree": 4}
strategy.comm_quant = True
strategy.comm_quant_configs = {"block_size": 128}
fleet.init(is_collective=True, strategy=strategy)
assert cq.get_active_config().block_size == 128
lin = nn.Linear(300, 4, device="cpu")
with torch.no_grad():
    lin.weight.copy_(t(D["dp/w"]))
model = fleet.distributed_model(lin)
(model(t(D["dp/x"][RANK % 2])) ** 2).mean().backward()
assert model._quant_sync_count == 1 and model._sync_count == 1
out[f"fleet/synced/{RANK}"] = lin.weight.grad.numpy().copy()
fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
assert cq.get_active_config() is None
ok("fleet")
np.savez(f"{DATA}/port_{RANK}.npz", **out)
ok("saved")
"""


def _jax_cfg(name):
    from paddle_tpu.distributed import comm_quant as jcq
    return jcq.QuantConfig(**CFGS[name])


def _smap(n_or_mesh, spec, fn):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.distributed.sharding_api import compat_shard_map
    mesh = n_or_mesh if not isinstance(n_or_mesh, int) else \
        Mesh(np.asarray(jax.devices()[:n_or_mesh]), ("dp",))
    spec = P(*spec)
    return jax.jit(compat_shard_map()(fn, mesh=mesh, in_specs=spec,
                                      out_specs=spec, check_vma=False))


def _reference(data):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from paddle_tpu.distributed import comm_quant as jcq
    from paddle_tpu.distributed.sharding_api import build_mesh, dcn_grad_sync
    ref = {}
    for n in (4, 2):
        x = data[f"ar/{n}"]
        for name in CFGS:
            if n == 4 and name != "int8":
                continue
            cfg = _jax_cfg(name)
            ref[f"ar/{n}/{name}/sum"] = np.asarray(_smap(n, ("dp",), (
                lambda v, c=cfg: jcq.quantized_all_reduce(
                    v[0], "dp", c, op="sum")[None]))(x))
            ref[f"ag/{n}/{name}"] = np.asarray(_smap(n, ("dp",), (
                lambda v, c=cfg: jcq.quantized_all_gather(
                    v[0], "dp", c)[None]))(x[:, :130]))
        ref[f"ar/{n}/int8/mean"] = np.asarray(_smap(n, ("dp",), (
            lambda v: jcq.quantized_all_reduce(v[0], "dp", op="mean")[None]))(
                x))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dcn", "dp"))
    for op in ("sum", "mean"):
        ref[f"hier/{op}"] = np.asarray(_smap(mesh, ("dcn", "dp"), (
            lambda v, o=op: jcq.hierarchical_all_reduce(
                v[0, 0], "dp", "dcn", jcq.QuantConfig(), op=o)[None, None]))(
                    data["hier"]))
    bm = build_mesh(dp=2, dcn_dp=2, devices=jax.devices()[:4])
    for quant in ("fp32", "int8"):
        cfg = None if quant == "fp32" else jcq.QuantConfig()
        for op in ("sum", "mean"):
            ref[f"dcn/{quant}/{op}"] = np.asarray(
                dcn_grad_sync(data["dcn"], bm, quant=cfg, op=op))
    one = Mesh(np.asarray(jax.devices()[:2]), ("sharding",))
    for name in ("int8", "int8_bf16_128"):
        for key in [k for k in data if k.startswith("zero/")]:
            ref[f"zero/{name}/{key[5:]}"] = np.asarray(jcq.quantized_replicate(
                jnp.asarray(data[key]), one, _jax_cfg(name)))
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("comm_quant_program")
    rng = np.random.default_rng(0)
    data = {"ar/4": rng.standard_normal((4, N_AR)).astype(np.float32),
            "ar/2": rng.standard_normal((2, N_AR)).astype(np.float32) * 3,
            "hier": rng.standard_normal((2, 2, N_AR)).astype(np.float32),
            "dcn": rng.standard_normal((2, 300)).astype(np.float32),
            "zero/0.weight": rng.standard_normal((64, 32)).astype(
                np.float32),
            "zero/0.bias": rng.standard_normal(32).astype(np.float32),
            "zero/1.weight": (1 + 0.1 * rng.standard_normal(768)).astype(
                np.float32),
            "zero/1.bias": rng.standard_normal(768).astype(np.float32) * 0.01,
            "dp/w": rng.standard_normal((300, 4)).astype(np.float32) * 0.1,
            "dp/x": rng.standard_normal((2, 8, 300)).astype(np.float32)}
    # a block whose entries all sit in one rank's half, and one whose amax
    # sits in the other rank's half of a straddling block
    data["zero/1.weight"][256:384] *= 0.01
    data["zero/1.weight"][500] = 7.0
    ref = _reference(data)
    save_npz(d / "inputs.npz", cfgs=np.array(json.dumps(CFGS)), **data)
    logs = run_ranks(d, _WORKER, {"dp_degree": 4}, nproc=4)
    port = {}
    for r in range(4):
        port.update(np.load(d / f"port_{r}.npz"))
    return {"logs": logs, "ref": ref, "port": port, "data": data}


def _dp_coord(n, rank):
    """This rank's index on the dp axis of the n = 4 and n = 2 meshes."""
    return rank if n == 4 else rank // 2


@pytest.mark.parametrize("case", ["4/int8/sum", "4/int8/mean", "2/int8/sum",
                                  "2/int8/mean", "2/int8_bf16_128/sum",
                                  "2/fp8/sum"])
def test_quantized_all_reduce_is_the_reference_ring(run, case):
    assert_check(run["logs"], "ring", nproc=4)
    n = int(case[0])
    want = run["ref"][f"ar/{case}"]
    for r in range(4):
        got = run["port"][f"ar/{case}/{r}"]
        np.testing.assert_array_equal(got, want[_dp_coord(n, r)])
        np.testing.assert_array_equal(got, run["port"][f"ar/{case}/0"])
    exact = run["data"][f"ar/{n}"].sum(0)
    if case.endswith("mean"):
        exact = exact / n
    assert 0 < np.abs(got - exact).max() < 0.05 * np.abs(exact).max()


@pytest.mark.parametrize("case", ["4/int8", "2/int8", "2/int8_bf16_128",
                                  "2/fp8"])
def test_quantized_all_gather_is_the_reference(run, case):
    assert_check(run["logs"], "ring", nproc=4)
    n = int(case[0])
    want = run["ref"][f"ag/{case}"]
    for r in range(4):
        got = run["port"][f"ag/{case}/{r}"]
        assert got.shape == (n, 130)
        np.testing.assert_array_equal(got, want[_dp_coord(n, r)])


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_hierarchical_all_reduce_is_the_reference(run, op):
    assert_check(run["logs"], "dcn", nproc=4)
    want = run["ref"][f"hier/{op}"]
    for r in range(4):
        np.testing.assert_array_equal(run["port"][f"hier/{op}/{r}"],
                                      want[r // 2, r % 2])


@pytest.mark.parametrize("case", ["fp32/sum", "fp32/mean", "int8/sum",
                                  "int8/mean", "fp32/async", "int8/async"])
def test_dcn_grad_sync_is_the_reference(run, case):
    assert_check(run["logs"], "dcn", nproc=4)
    quant, op = case.split("/")
    want = run["ref"][f"dcn/{quant}/{'mean' if op == 'async' else op}"]
    for r in range(4):
        np.testing.assert_array_equal(run["port"][f"dcn/{case}/{r}"],
                                      want[r // 2])
    parts = run["data"]["dcn"]
    if quant == "fp32" and op == "sum":
        np.testing.assert_array_equal(want[0], parts[0] + parts[1])


@pytest.mark.parametrize("name", ["0.weight", "0.bias", "1.weight",
                                  "1.bias"])
def test_zero3_gather_exact_then_quantized_is_the_reference(run, name):
    assert_check(run["logs"], "zero3", nproc=4)
    whole = run["data"][f"zero/{name}"]
    for r in range(4):
        np.testing.assert_array_equal(run["port"][f"zero/exact/{name}/{r}"],
                                      whole)
        for cfg in ("int8", "int8_bf16_128"):
            got = run["port"][f"zero/{cfg}/{name}/{r}"]
            np.testing.assert_array_equal(got, run["ref"][
                f"zero/{cfg}/{name}"])
    got = run["port"][f"zero/int8/{name}/0"]
    assert 0 < np.abs(got - whole).max() <= np.abs(whole).max() / 254 + 1e-7


def test_zero3_quantized_gather_moves_codes(run):
    """Codes (one byte an element), the scales of the blocks a rank
    starts and two edge amaxes, against 4 bytes an element in fp32."""
    assert_check(run["logs"], "zero3", nproc=4)
    elems = sum(v.size for k, v in run["data"].items()
                if k.startswith("zero/")) // 2
    sent = int(run["port"]["zero/bytes/int8/0"])
    assert elems < sent < elems * 1.1


def test_quantized_dp_step_with_error_feedback(run):
    assert_check(run["logs"], "dp_quant", nproc=4)
    port = run["port"]
    for step in range(2):
        for pair in ((0, 2), (1, 3)):
            a, b = (port[f"dp/{step}/synced/{r}"] for r in pair)
            np.testing.assert_array_equal(a, b)
            comp = [port[f"dp/{step}/compensated/{r}"] for r in pair]
            exact = (comp[0] + comp[1]) / 2
            bound = max(np.abs(g).max() for g in comp) / 127
            assert np.abs(a - exact).max() <= bound


def test_fleet_comm_quant_syncs_distributed_model_quantized(run):
    assert_check(run["logs"], "fleet", nproc=4)
    port = run["port"]
    for r in range(1, 4):
        np.testing.assert_array_equal(port[f"fleet/synced/{r}"],
                                      port["fleet/synced/0"])


def test_traced_codec_is_the_reference_compiled_codec():
    """The reference's in-program forms run compiled, where XLA turns
    amax / 127 into amax times the fp32 reciprocal; ``traced=True`` does
    the same, the eager codec divides as the reference's eager one."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.distributed import comm_quant as jcq
    from paddle_tpu_torch.distributed import comm_quant as cq
    x = np.random.default_rng(3).standard_normal(65536).astype(np.float32)
    jq, js = jax.jit(jcq.quantize_blockwise)(x)
    q, s = cq.quantize_blockwise(torch.from_numpy(x), traced=True)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    eq, es = jcq.quantize_blockwise(jnp.asarray(x))
    q, s = cq.quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(es))
    assert not np.array_equal(np.asarray(es), np.asarray(js))


def test_in_program_forms_refuse_other_ops():
    from paddle_tpu_torch.distributed import comm_quant as cq
    from paddle_tpu_torch.distributed.collective import Group
    with pytest.raises(NotImplementedError, match="sum/mean"):
        cq.quantized_all_reduce(torch.ones(4), Group([0]), op="max")
    with pytest.raises(NotImplementedError, match="hierarchical"):
        cq.hierarchical_all_reduce(torch.ones(4), Group([0]), Group([0]),
                                   op="max")
    # a group of one: one codec round trip, as the reference's n == 1
    x = torch.linspace(-1, 1, 300)
    torch.testing.assert_close(
        cq.quantized_all_reduce(x, Group([0])),
        cq.quantization_roundtrip(x, traced=True), rtol=0, atol=0)
    assert cq.quantized_all_gather(x, Group([0])).shape == (1, 300)
