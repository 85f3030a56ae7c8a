"""The fleet executor of the port (``paddle_tpu_torch.distributed.
fleet_executor``) in one process: the reference's cases
(``tests/test_fleet_executor.py``) mirrored, and a 2-layer GPT cut into
stages run through the port's ``FleetExecutor`` against the JAX GPT cut
the same way through the JAX ``FleetExecutor``, from the same weights
(``convert.load_jax_gpt``) and token ids, within 1e-5 of the largest
logit; on the CPU the port's attention takes the plain version of K2.
The port's executor output is also bit-identical to its model run
straight."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.fleet_executor import (Carrier,
                                                         FleetExecutor,
                                                         TaskNode)

from _torch_hybrid_helpers import GPT_KW, rel_err

TOL = 1e-5


class TestLinearPipeline:
    def test_stage_order_and_results(self):
        ex = FleetExecutor.from_stages([
            lambda x: x + 1,
            lambda x: x * 2,
            lambda x: x - 3,
        ])
        out = ex.run(range(8))
        assert out == [(i + 1) * 2 - 3 for i in range(8)]

    def test_tensor_stages(self):
        def stage1(x):
            return torch.matmul(x, x)

        def stage2(x):
            return float(torch.sum(x))

        xs = [torch.eye(3) * (i + 1) for i in range(4)]
        out = FleetExecutor.from_stages([stage1, stage2]).run(xs)
        np.testing.assert_allclose(out, [3.0 * (i + 1) ** 2
                                         for i in range(4)])

    def test_max_run_times_truncates(self):
        node = TaskNode(lambda x: x, max_run_times=3)
        c = Carrier()
        c.add_task(node)
        out = c.run(range(10), num_micro_batches=3)
        assert out == [0, 1, 2]


class TestDagShapes:
    def test_diamond_join(self):
        c = Carrier()
        a = c.add_task(TaskNode(lambda x: x, name="a"))
        b = c.add_task(TaskNode(lambda x: x + 10, name="b"))
        d = c.add_task(TaskNode(lambda x: x * 10, name="d"))
        j = c.add_task(TaskNode(lambda u, v: (u, v), name="join"))
        a.add_downstream(b)
        a.add_downstream(d)
        b.add_downstream(j)
        d.add_downstream(j)
        out = c.run([1, 2, 3])
        assert out == [(11, 10), (12, 20), (13, 30)]

    def test_error_propagates_to_caller(self):
        def boom(x):
            if x == 2:
                raise ValueError("bad microbatch")
            return x

        ex = FleetExecutor.from_stages([boom, lambda x: x * 2])
        with pytest.raises(RuntimeError, match="stage0"):
            ex.run(range(5))

    def test_backpressure_bounded_queue(self):
        # a slow sink with capacity 2: the fast source must block, not
        # buffer unboundedly; completion proves no deadlock either
        import time
        seen = []

        def slow(x):
            time.sleep(0.002)
            seen.append(x)
            return x

        ex = FleetExecutor.from_stages([lambda x: x, slow], capacity=2)
        out = ex.run(range(30))
        assert out == list(range(30)) and seen == list(range(30))


def _port_stages(model):
    """The port's GPT in stages: embeddings + block 0, block 1, norm +
    head, each as ``GPTModel.forward`` computes it, without autograd
    (grad mode is per thread)."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.math import add
    gpt = model.gpt

    @torch.no_grad()
    def embed(ids):
        pos = torch.arange(ids.shape[1])[None]
        x = add(F.embedding(ids, gpt.wte.weight),
                F.embedding(pos, gpt.wpe.weight))
        return gpt.blocks[0](gpt.drop(x))

    @torch.no_grad()
    def head(x):
        return model._logits(gpt.ln_f(x))

    return [embed, torch.no_grad()(gpt.blocks[1]), head]


def _jax_stages(model):
    import paddle_tpu as paddle
    from paddle_tpu.ops.linalg import matmul
    gpt = model.gpt

    def embed(ids):
        s = ids.shape[1]
        pos = paddle.unsqueeze(paddle.arange(s, dtype="int64"), 0)
        return gpt.blocks[0](gpt.drop(gpt.wte(ids) + gpt.wpe(pos)))

    def head(x):
        return matmul(gpt.ln_f(x), gpt.wte.weight, transpose_y=True)

    return [embed, gpt.blocks[1], head]


def test_gpt_stages_match_the_jax_executor():
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet_executor import \
        FleetExecutor as JaxFleetExecutor
    from paddle_tpu.text.gpt import GPTConfig as JaxConfig
    from paddle_tpu.text.gpt import GPTForPretraining as JaxGPT

    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining

    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**GPT_KW))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    pm = load_jax_gpt(GPTForPretraining(GPTConfig(**GPT_KW), device="cpu"),
                      state)
    pm.eval()
    rng = np.random.default_rng(3)
    micro = [rng.integers(0, GPT_KW["vocab_size"],
                          (2, GPT_KW["max_seq_len"])).astype(np.int64)
             for _ in range(4)]
    got = FleetExecutor.from_stages(_port_stages(pm)).run(
        [torch.as_tensor(m) for m in micro])
    want = JaxFleetExecutor.from_stages(_jax_stages(jm)).run(
        [paddle.to_tensor(m) for m in micro])
    for g, w, m in zip(got, want, micro):
        assert rel_err(g.numpy(), np.asarray(w._value)) <= TOL
        with torch.no_grad():
            assert torch.equal(g, pm(torch.as_tensor(m)))


def test_a_failing_stage_names_itself():
    """A stage that raises on one microbatch reaches the caller as the
    reference's RuntimeError, with the stage's error as its cause."""
    def stage1(x):
        if x == 3:
            raise ValueError("microbatch 3")
        return x

    ex = FleetExecutor.from_stages([lambda x: x, stage1, lambda x: x])
    with pytest.raises(RuntimeError, match="stage1") as info:
        ex.run(range(8))
    assert isinstance(info.value.__cause__, ValueError)
