"""Resharding through the port's ``distributed.checkpoint``: each rank
writes its slices of the tensors split over mp or ZeRO (replicated ones
by one rank), and a load cuts each destination's own slices out of
whatever slices the shards hold. Two gloo ranks on the CPU, launched once
for the file; the one-process sides and the JAX package run in this
process.

- mp 2 -> 1: a TP GPT's parameters and AdamW moments after a step,
  saved by two ranks, load into one process bit-equal to the ranks'
  gathered values; rank 1's shard holds no replicated tensor.
- 1 -> mp 2: one process's checkpoint (parameters and moments) loads
  into the two TP ranks, each slice bit-equal to its piece of the whole.
- ZeRO-3 2 -> 1: a ``p_g_os`` GPT's rows, saved by two ranks, load into
  one process bit-equal to the gathered parameters.
- The JAX package's checkpoint of a GPT sharded over its 8-device mesh
  (dp 4 x mp 2) loads into mp 2, each slice bit-equal.
- A flipped byte in a shard is refused before unpickling.
"""
import shutil

import numpy as np
import pytest
import torch

from _torch_hybrid_helpers import GPT_KW, assert_check, run_ranks, save_npz

_WORKER = """
from paddle_tpu_torch.distributed import checkpoint as dck
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining

KW = json.loads(open(f"{DATA}/kw.json").read())
B = np.load(f"{DATA}/batch.npz")
ids, labels = torch.from_numpy(B["ids"]), torch.from_numpy(B["labels"])


def model_opt(seed, **cfg):
    m = GPTForPretraining(GPTConfig(**cfg, **KW), device="cpu", seed=seed)
    opt = AdamW(learning_rate=1e-3, parameters=m.named_parameters())
    for p in m.parameters():
        opt._get_accumulators(p)
    return m, opt


def same_pieces(tensors, whole):
    for n, t in tensors:
        pl = placement_of(t)
        want = pl.take(whole[n]) if pl is not None else whole[n]
        assert np.array_equal(t.detach().numpy(), want), n


# 1 -> mp 2: parameters and moments
W = np.load(f"{DATA}/whole.npz")
m, opt = model_opt(7, tensor_parallel=True)
state = {"model": m.state_dict(), "opt": opt.state_dict()}
dck.load_state_dict(state, f"{DATA}/whole")
opt.set_state_dict(state["opt"])
same_pieces(m.named_parameters(), {k[6:]: W[k] for k in W.files
                                   if k.startswith("param/")})
same_pieces([(k, v) for k, v in opt.state_dict().items()
             if k.endswith("moment1") or k.endswith("moment2")],
            {k[4:]: W[k] for k in W.files if k.startswith("opt/")})
assert opt._step_count == 1
ok("whole_into_mp2")

# the JAX package's 8-device checkpoint -> mp 2
J = np.load(f"{DATA}/jax8.npz")
m, _ = model_opt(8, tensor_parallel=True)
state = {"model": m.state_dict()}
dck.load_state_dict(state, f"{DATA}/jax8")
same_pieces(m.named_parameters(), dict(J))
ok("jax8_into_mp2")

# mp 2 -> 1: save a TP model's state after a step
m, opt = model_opt(9, tensor_parallel=True)
CompiledTrainStep(lambda a, b: m(a, labels=b)[1], m, opt)(ids, labels)
dck.save_state_dict({"model": m.state_dict(), "opt": opt.state_dict()},
                    f"{DATA}/tp")
got = {f"param/{n}": gather_global(p).numpy()
       for n, p in m.named_parameters()}
got.update({f"opt/{k}": gather_global(v).numpy()
            for k, v in opt.state_dict().items() if torch.is_tensor(v)})
if RANK == 0:
    np.savez(f"{DATA}/tp_gathered.npz", **got)
ok("tp_saved")

# ZeRO-3 2 -> 1, on a sharding-2 mesh
strategy = fleet.DistributedStrategy()
strategy.hybrid_configs = {"dp_degree": 1, "sharding_degree": 2}
fleet.init(is_collective=True, strategy=strategy)
m, opt = model_opt(10)
net, opt2, _ = group_sharded_parallel(m, opt, "p_g_os")
half = slice(2 * RANK, 2 * RANK + 2)
CompiledTrainStep(lambda a, b: net(a, labels=b)[1], m, opt)(ids[half],
                                                           labels[half])
dck.save_state_dict({"model": m.state_dict()}, f"{DATA}/zero3")
got = {n: gather_global(p).numpy() for n, p in m.named_parameters()}
if RANK == 0:
    np.savez(f"{DATA}/zero3_gathered.npz", **got)
ok("zero3_saved")
"""


def _one_process(d):
    """One process's GPT and AdamW moments after a step, checkpointed."""
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 128, (4, 32)).astype(np.int64)
    labels = rng.integers(0, 128, (4, 32)).astype(np.int64)
    save_npz(d / "batch.npz", ids=ids, labels=labels)
    m = GPTForPretraining(GPTConfig(**GPT_KW), device="cpu", seed=3)
    opt = AdamW(learning_rate=1e-3, parameters=m.named_parameters())
    CompiledTrainStep(lambda a, b: m(a, labels=b)[1], m, opt)(
        torch.from_numpy(ids), torch.from_numpy(labels))
    dck.save_state_dict({"model": m.state_dict(), "opt": opt.state_dict()},
                        str(d / "whole"))
    save_npz(d / "whole.npz",
             **{f"param/{n}": p.detach().numpy()
                for n, p in m.named_parameters()},
             **{f"opt/{k}": v.numpy() for k, v in opt.state_dict().items()
                if torch.is_tensor(v)})


def _jax_8_devices(d):
    """The JAX package's GPT state placed over its 8-device mesh (dp 4 x
    mp 2 where the shapes divide) and written by its checkpoint."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import paddle_tpu as jpaddle
    from paddle_tpu.distributed import checkpoint as jdck
    from paddle_tpu.distributed.sharding_api import build_mesh
    from paddle_tpu.text.gpt import GPTConfig, GPTForPretraining
    jpaddle.seed(4)
    jm = GPTForPretraining(GPTConfig(**GPT_KW))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    mesh = build_mesh(dp=4, mp=2)
    placed = {}
    for k, v in state.items():
        spec = [a if v.shape[i] % n == 0 else None
                for i, (a, n) in enumerate((("dp", 4), ("mp", 2))[:v.ndim])]
        placed[k] = jpaddle.Tensor(jax.device_put(
            jnp.asarray(v), NamedSharding(mesh, P(*spec))))
    jdck.save_state_dict({"model": placed}, str(d / "jax8"))
    save_npz(d / "jax8.npz", **state)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import json
    d = tmp_path_factory.mktemp("reshard")
    (d / "kw.json").write_text(json.dumps(GPT_KW))
    _one_process(d)
    _jax_8_devices(d)
    logs = run_ranks(d, _WORKER, {"dp_degree": 1, "mp_degree": 2})
    return {"logs": logs, "dir": d}


def _one_process_skeleton(seed):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    m = GPTForPretraining(GPTConfig(**GPT_KW), device="cpu", seed=seed)
    opt = AdamW(learning_rate=1e-3, parameters=m.named_parameters())
    for p in m.parameters():
        opt._get_accumulators(p)
    return m, opt


def test_mp2_checkpoint_loads_into_one_process(run):
    from paddle_tpu_torch.distributed import checkpoint as dck
    assert_check(run["logs"], "tp_saved")
    d = run["dir"]
    want = dict(np.load(d / "tp_gathered.npz"))
    m, opt = _one_process_skeleton(11)
    state = {"model": m.state_dict(), "opt": opt.state_dict()}
    dck.load_state_dict(state, str(d / "tp"))
    opt.set_state_dict(state["opt"])
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      want[f"param/{n}"], err_msg=n)
    for k, v in opt.state_dict().items():
        if torch.is_tensor(v) and f"opt/{k}" in want:
            np.testing.assert_array_equal(v.numpy(), want[f"opt/{k}"],
                                          err_msg=k)
    assert opt._step_count == 1


def test_replicated_tensors_are_written_by_one_rank(run):
    from paddle_tpu_torch.framework.io import read_pickle
    d = run["dir"] / "tp"
    shards = [read_pickle((d / f"shard_{r}.pkl").read_bytes())[0]
              for r in range(2)]
    assert "model.gpt.ln_f.weight" in shards[0]
    assert "model.gpt.ln_f.weight" not in shards[1]
    assert "model.gpt.wpe.weight" not in shards[1]
    for key in ("model.gpt.wte.weight",
                "model.gpt.blocks.0.attn.qkv_proj.weight"):
        assert key in shards[0] and key in shards[1]
    # the qkv piece of each rank: three column ranges, one of q, k, v
    assert len(shards[1]["model.gpt.blocks.0.attn.qkv_proj.weight"]) == 3


def test_one_process_checkpoint_loads_into_mp2(run):
    assert_check(run["logs"], "whole_into_mp2")


def test_zero3_checkpoint_loads_into_one_process(run):
    from paddle_tpu_torch.distributed import checkpoint as dck
    assert_check(run["logs"], "zero3_saved")
    d = run["dir"]
    want = dict(np.load(d / "zero3_gathered.npz"))
    m, _ = _one_process_skeleton(12)
    state = {"model": m.state_dict()}
    dck.load_state_dict(state, str(d / "zero3"))
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[n],
                                      err_msg=n)


def test_jax_8_device_checkpoint_loads_into_mp2(run):
    assert_check(run["logs"], "jax8_into_mp2")


def test_flipped_byte_is_refused(run, tmp_path):
    from paddle_tpu_torch.distributed import checkpoint as dck
    bad = tmp_path / "tp"
    shutil.copytree(run["dir"] / "tp", bad)
    shard = bad / "shard_1.pkl"
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    shard.write_bytes(bytes(raw))
    m, opt = _one_process_skeleton(13)
    with pytest.raises(ValueError, match="corrupt"):
        dck.load_state_dict({"model": m.state_dict()}, str(bad))
