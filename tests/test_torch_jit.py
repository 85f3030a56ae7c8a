"""``jit.to_static``, ``jit.save`` and ``jit.load`` of the port
(``paddle_tpu_torch/jit/``) against the JAX package.

- Mode equivalence (``tests/test_mode_equivalence.py``): the MLP's loss
  curve over 6 SGD steps through ``to_static`` against the eager one and
  against the reference's eager curve, at rtol 2e-5 (atol 2e-6), and its
  ``to_static`` forward against the reference's at 32·eps (the widest
  contraction, as the reference's own test bounds it).
- A tiny GPT (hidden 128, 2 heads of 64, 2 layers, vocab 256, 2 x 128
  tokens), so K2's gate admits its attention: its ``to_static`` logits
  against the reference's ``to_static`` logits at atol 1e-4 (two
  frameworks summing in different orders through two layers and a
  256-wide head, as ``test_torch_gpt.py`` bounds them) and bit-equal to
  the port's eager forward; its loss at atol 1e-5 and every gradient at
  atol 2e-6 against the reference's (``test_torch_train_step.py``'s
  bounds), with K3 (the plain version here) once per layer; ``jit.save``
  and ``jit.load`` in both packages with the loaded outputs agreeing as
  the logits do; the captured and the saved graphs hold the op
  ``paddle_tpu_torch::flash_fwd`` and no ``scaled_dot_product_attention``.
- A capture that reaches K1 or K4 raises, naming ROADMAP A10; ``jit.load``
  without ``device="cpu"`` raises without a card.

The JAX GPT runs as its own tests run it on the CPU: dense attention
(``PDTPU_PALLAS_INTERPRET`` off).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from _torch_helpers import jax_state
from _torch_ops_sweep import on_cpu  # noqa: F401  (the port's place: CPU)
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.ops import cuda_kernels as ck

GPT_KW = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=128, dropout=0.0)


@pytest.fixture(autouse=True)
def dense_jax_attention(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "0")


def _ids(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (2, 128)), rng.integers(0, 256, (2, 128))


@pytest.fixture(scope="module")
def gpts():
    """(reference GPT, port GPT, port eager GPT), the same weights; the
    first two through ``to_static``."""
    from paddle_tpu.text.gpt import GPTConfig as JConfig
    from paddle_tpu.text.gpt import GPTForPretraining as JGPT
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PDTPU_PALLAS_INTERPRET", "0")
        jpaddle.seed(0)
        jm = JGPT(JConfig(**GPT_KW))
        models = [GPTForPretraining(GPTConfig(**GPT_KW), device="cpu")
                  for _ in range(2)]
        for m in models:
            load_jax_gpt(m, jax_state(jm))
        jpaddle.jit.to_static(jm)
        tpaddle.jit.to_static(models[0])
    return jm, models[0], models[1]


def _graph_targets(program):
    return [str(n.target) for gm in program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.op == "call_function"]


def test_gpt_to_static_logits_match_the_reference_and_eager(gpts):
    jm, pm, eager = gpts
    jm.eval(), pm.eval(), eager.eval()
    ids, _ = _ids(0)
    want = jm(jpaddle.to_tensor(ids)).numpy()
    got = pm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)
    assert torch.equal(got, eager(torch.from_numpy(ids)))
    # one program for the signature; a new length is a new program
    pm(torch.from_numpy(ids))
    n = len(pm._static_forward.programs)
    pm(torch.from_numpy(ids[:, :64]))
    assert len(pm._static_forward.programs) == n + 1


def test_gpt_to_static_graph_holds_the_k2_op(gpts):
    _, pm, _ = gpts
    pm.eval()
    ids, _ = _ids(1)
    pm(torch.from_numpy(ids))
    for program, _ in pm._static_forward.programs.values():
        targets = _graph_targets(program)
        if "paddle_tpu_torch.flash_fwd.default" in targets:
            break
    else:
        raise AssertionError("no captured program holds flash_fwd")
    assert targets.count("paddle_tpu_torch.flash_fwd.default") == 2
    assert not any("scaled_dot_product_attention" in t for t in targets)


def test_gpt_to_static_loss_and_gradients_match_the_reference(gpts,
                                                              monkeypatch):
    jm, pm, _ = gpts
    jm.train(), pm.train()
    ids, labels = _ids(2)
    _, jloss = jm(jpaddle.to_tensor(ids), labels=jpaddle.to_tensor(labels))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    jm.clear_gradients()
    calls = []
    real = ck.flash_attention_bwd
    monkeypatch.setattr(ck, "flash_attention_bwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    pm.zero_grad()
    _, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    assert len(calls) == 2   # K3 once per layer
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), atol=1e-5,
                               rtol=0)
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=2e-6,
                                   rtol=0, err_msg=name)
    pm.zero_grad()
    pm.eval(), jm.eval()


def test_gpt_save_load_agree_across_packages(gpts, tmp_path):
    jm, pm, eager = gpts
    jm.eval(), pm.eval()
    spec = [([2, 128], "int64")]
    jpaddle.jit.save(jm, str(tmp_path / "ref"), input_spec=[
        jpaddle.static.InputSpec(*s) for s in spec])
    tpaddle.jit.save(pm, str(tmp_path / "port"), input_spec=[
        tpaddle.static.InputSpec(*s) for s in spec])
    ids, _ = _ids(3)
    want = jpaddle.jit.load(str(tmp_path / "ref"))(
        jpaddle.to_tensor(ids)).numpy()
    loaded = tpaddle.jit.load(str(tmp_path / "port"), device="cpu")
    got = loaded(tpaddle.to_tensor(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert torch.equal(got._value, eager.eval()(torch.from_numpy(ids)))
    targets = _graph_targets(loaded._program)
    assert "paddle_tpu_torch.flash_fwd.default" in targets
    assert not any("scaled_dot_product_attention" in t for t in targets)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tpaddle.jit.load(str(tmp_path / "port"))   # the card by default


def test_capture_reaching_k1_or_k4_raises_naming_a10():
    from _torch_helpers import paged_inputs, varlen_inputs
    q, kp, vp, bt, cl = (torch.from_numpy(a) for a in paged_inputs(
        [5, 9], 1))
    q = q[:, 0]

    @tpaddle.jit.to_static
    def decode(q, kp, vp, bt, cl):
        return ck.paged_attention_decode(q, kp, vp, bt, cl)

    with pytest.raises(RuntimeError, match="K1.*A10"):
        decode(q, kp, vp, bt, cl)
    vq, vk, vv, cu, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                         else a for a in varlen_inputs([128, 64]))

    @tpaddle.jit.to_static
    def packed(q, k, v, cu):
        return ck.flash_attention_varlen_values(q, k, v, cu, cu, 0.125)

    with pytest.raises(RuntimeError, match="K4.*A10"):
        packed(vq, vk, vv, cu)
    x = tpaddle.static.data("q", list(vq.shape))
    with pytest.raises(RuntimeError, match="K4.*A10"):
        ck.flash_attention_varlen_values(x, x, x, cu, cu, 0.125)


# -- mode equivalence ------------------------------------------------------------

def _mlp(pd, ref=None):
    dev = {"device": "cpu"} if pd is tpaddle else {}
    if ref is None:
        jpaddle.seed(42)
    net = pd.nn.Sequential(
        pd.nn.Linear(12, 32, **dev), pd.nn.Tanh(),
        pd.nn.Linear(32, 8, **dev), pd.nn.ReLU(), pd.nn.Linear(8, 1, **dev))
    if ref is not None:
        with torch.no_grad():
            for p, q in zip(net.parameters(), ref.parameters()):
                p.copy_(torch.from_numpy(np.array(q.numpy())))
    return net


def _data(pd):
    rng = np.random.RandomState(0)
    return (pd.to_tensor(rng.rand(16, 12).astype(np.float32)),
            pd.to_tensor(rng.rand(16, 1).astype(np.float32)))


def _curve(pd, net, static=False, steps=6, lr=0.05):
    opt = pd.optimizer.SGD(learning_rate=lr, parameters=net.parameters())
    if static:
        net = pd.jit.to_static(net)
    x, y = _data(pd)
    losses = []
    for _ in range(steps):
        loss = pd.mean(pd.square(net(x) - y))   # mse_loss
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, net


def test_mlp_loss_curve_to_static_against_eager_and_the_reference():
    ref = _mlp(jpaddle)
    want, _ = _curve(jpaddle, ref)
    ref = _mlp(jpaddle)
    eager, _ = _curve(tpaddle, _mlp(tpaddle, ref))
    static, net = _curve(tpaddle, _mlp(tpaddle, ref), static=True)
    np.testing.assert_allclose(static, eager, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(static, want, rtol=2e-5, atol=2e-6)
    assert len(net._static_forward.programs) == 1   # one capture, 6 steps


def test_mlp_to_static_forward_matches_the_reference():
    ref = _mlp(jpaddle)
    port = tpaddle.jit.to_static(_mlp(tpaddle, ref))
    want = jpaddle.jit.to_static(ref)(_data(jpaddle)[0]).numpy()
    got = port(_data(tpaddle)[0]).numpy()
    np.testing.assert_allclose(got, want,
                               rtol=32 * np.finfo(np.float32).eps)
