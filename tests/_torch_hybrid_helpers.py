"""Shared pieces of the port's hybrid-parallel tests: one launch of the
port's ranks per test file (a worker script that runs every check of the
file and prints ``rank<r> <check> ok`` per check), the tiny GPT both
packages build, and the comparisons the files state their tolerances
for. The reference runs in the test process; the ranks import only the
port."""
import json
from pathlib import Path

import numpy as np

from _torch_dist_helpers import launch

# the tiny GPT of the hybrid tests: 2 layers, hidden 64, 4 heads of 16,
# vocab 128, sequence 32
GPT_KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=32, dropout=0.0)

# the worker's prelude: join the world, make the fleet mesh from argv[1]
# (hybrid_configs as JSON), read inputs from argv[2]
PRELUDE = """
import json, sys
import numpy as np
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.sharding_api import (gather_global,
                                                       get_default_mesh,
                                                       placement_of)
dist.init_parallel_env(device="cpu")
HYBRID = json.loads(sys.argv[1])
DATA = sys.argv[2]
strategy = fleet.DistributedStrategy()
strategy.hybrid_configs = HYBRID
fleet.init(is_collective=True, strategy=strategy)
RANK = dist.get_rank()
MESH = get_default_mesh()
torch.manual_seed(0)


def ok(check):
    print(f"rank{RANK} {check} ok", flush=True)


def gathered(tensors):
    '''{name: global numpy array} of (name, tensor, placement) triples.'''
    return {n: gather_global(t, pl).numpy() for n, t, pl in tensors}
"""


def run_ranks(tmp_path, body, hybrid, nproc=2, timeout=240):
    """Run PRELUDE + ``body`` on ``nproc`` ranks with the fleet mesh
    ``hybrid``; the data directory is ``tmp_path``. Returns the logs."""
    proc, logs = launch(tmp_path, PRELUDE + body, nproc=nproc,
                        timeout=timeout,
                        args=(json.dumps(hybrid), str(tmp_path)))
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:],
                                  {k: v[-6000:] for k, v in logs.items()})
    return logs


def assert_check(logs, check, nproc=2):
    for r in range(nproc):
        assert f"rank{r} {check} ok" in logs.get(f"workerlog.{r}", ""), \
            logs.get(f"workerlog.{r}", "")[-4000:]


def rel_err(got, want):
    """max |got - want| over the largest |want| (0 for an all-zero pair)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = float(np.abs(want).max()) if want.size else 0.0
    diff = float(np.abs(got - want).max()) if want.size else 0.0
    return diff / top if top else diff


def adamw_first_step(g, lr=1e-3, eps=1e-8):
    """AdamW's first update of a zero parameter with gradient ``g``
    (bias-corrected: lr * g / (|g| + eps), fp64)."""
    g = np.asarray(g, np.float64)
    return -lr * g / (np.abs(g) + eps)


def param_rule_err(got, want, g_got, g_want, lr=1e-3):
    """PR 14's rule for an updated parameter: every entry of p_got -
    p_want - (z(g_got) - z(g_want)), z AdamW's first step from zero, over
    the tensor's largest entry. Where |g| is near eps the update hangs on
    digits fp32 leaves open; the rule takes that difference out."""
    want = np.asarray(want, np.float64)
    diff = np.asarray(got, np.float64) - want
    diff -= adamw_first_step(g_got, lr) - adamw_first_step(g_want, lr)
    return float(np.abs(diff).max()) / float(np.abs(want).max())


def save_npz(path, **arrays):
    np.savez(Path(path), **{k: np.asarray(v) for k, v in arrays.items()})


def gpt_reference(d):
    """The JAX package's TP GPT on its mp-2 mesh: the whole gradients of
    one batch, then two AdamW steps of its compiled step."""
    import json

    import jax

    import paddle_tpu as paddle
    from paddle_tpu.distributed.sharding_api import (build_mesh,
                                                     set_default_mesh)
    from paddle_tpu.jit.train_step import CompiledTrainStep
    from paddle_tpu.text.gpt import GPTConfig, GPTForPretraining
    set_default_mesh(build_mesh(dp=1, mp=2, devices=jax.devices()[:2]))
    try:
        paddle.seed(0)
        jm = GPTForPretraining(GPTConfig(tensor_parallel=True, **GPT_KW))
        state = _jax_state(jm)
        rng = np.random.default_rng(5)
        ids = rng.integers(0, 128, (4, 32)).astype(np.int64)
        labels = rng.integers(0, 128, (4, 32)).astype(np.int64)
        _, loss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss.backward()
        grads = {n: np.asarray(p.grad._value)
                 for n, p in jm.named_parameters()}
        # the updated parameters from these gradients (an eager AdamW
        # step: the rule below needs the gradients the update used)
        paddle.optimizer.AdamW(learning_rate=1e-3,
                               parameters=jm.parameters()).step()
        params = _jax_state(jm)
        jm.clear_gradients()
        jm.set_state_dict(state)
        # the loss trajectory of its compiled step from the same weights
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=jm.parameters())
        step = CompiledTrainStep(lambda i, lb: jm(i, labels=lb)[1], jm, opt,
                                 donate=False)
        t_ids, t_labels = paddle.to_tensor(ids), paddle.to_tensor(labels)
        loss1 = float(np.asarray(step(t_ids, t_labels)._value))
        loss2 = float(np.asarray(step(t_ids, t_labels)._value))
    finally:
        set_default_mesh(None)
    save_npz(d / "gpt.npz", ids=ids, labels=labels,
             kw=np.array(json.dumps(GPT_KW)),
             **{f"state/{k}": v for k, v in state.items()})
    return {"state": state, "grads": grads, "params": params,
            "loss0": float(np.asarray(loss._value)), "loss1": loss1,
            "loss2": loss2}


def _jax_state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}
