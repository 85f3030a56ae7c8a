"""The port's GPT (``paddle_tpu_torch/text/gpt.py``) loaded with a JAX
model's weights through ``paddle_tpu_torch/convert.py``: logits, greedy
``generate`` and the weight bridge, at hidden 128, 2 heads (d = 64),
2 layers, vocab 128.

Logits agree at atol 1e-4 in fp32 (the two frameworks sum in different
orders through two layers and a 128-wide head); greedy tokens are equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _torch_helpers import jax_state, tiny_models
from paddle_tpu.inference.serving.engine import extract_gpt_params
from paddle_tpu_torch.convert import gpt_state_from_jax, load_jax_gpt
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def models(request):
    return tiny_models(tied=request.param)


def _ids(b, s, seed):
    return np.random.default_rng(seed).integers(1, 128, (b, s))


@pytest.mark.parametrize("b,s", [(2, 40), (1, 128)])
def test_logits_match_jax(models, b, s):
    jm, pm = models
    ids = _ids(b, s, seed=s)
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    assert got.shape == (b, s, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_loss_matches_jax(models):
    jm, pm = models
    ids, labels = _ids(2, 24, seed=3), _ids(2, 24, seed=4)
    _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    with torch.no_grad():
        _, loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(np.asarray(jloss._value)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("s", [9, 128])
def test_greedy_generate_matches_jax(models, s):
    jm, pm = models
    ids = _ids(1, s, seed=10 + s)
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=8)._value)
    got = pm.generate(torch.from_numpy(ids), max_new_tokens=8).numpy()
    assert got.tolist() == want.tolist()


def test_prefill_of_a_128_token_prompt_takes_the_kernel_route(models):
    _, pm = models
    ids = torch.from_numpy(_ids(1, 128, seed=5))
    calls = []
    real = ck.flash_attention_with_lse

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    ck.flash_attention_with_lse = spy
    try:
        pm.generate(ids, max_new_tokens=2)
    finally:
        ck.flash_attention_with_lse = real
    # one prefill call per layer; the one-token steps take the dense path
    assert calls == [torch.Size([1, 128, 2, 64])] * 2


def test_bridge_carries_paddle_layout_without_transpose(models):
    jm, pm = models
    state = jax_state(jm)
    w = state["gpt.blocks.0.attn.qkv_proj.weight"]
    assert w.shape == (128, 384)                # Paddle [in, out]
    port_w = pm.gpt.blocks[0].attn.qkv_proj.weight
    assert tuple(port_w.shape) == (128, 384)
    np.testing.assert_array_equal(port_w.detach().numpy(), w)


def test_bridge_takes_the_engine_param_tree(models):
    jm, pm = models
    tree = extract_gpt_params(jm)
    np_tree = {k: ([{bk: np.asarray(bv) for bk, bv in blk.items()}
                    for blk in v] if k == "blocks" else np.asarray(v))
               for k, v in tree.items()}
    assert gpt_state_from_jax(np_tree).keys() == jax_state(jm).keys()
    fresh = GPTForPretraining(pm.config, device="cpu", seed=7)
    load_jax_gpt(fresh, np_tree)
    for (name, a), (_, b) in zip(fresh.named_parameters(),
                                 pm.named_parameters()):
        assert torch.equal(a, b), name


def test_bridge_refuses_mismatched_weights(models):
    jm, pm = models
    state = jax_state(jm)
    other = GPTConfig(vocab_size=128, hidden_size=128, num_layers=2,
                      num_heads=2, max_seq_len=256,
                      tie_word_embeddings=not pm.config.tie_word_embeddings)
    with pytest.raises(KeyError):
        load_jax_gpt(GPTForPretraining(other, device="cpu"), state)
    state["gpt.wte.weight"] = state["gpt.wte.weight"][:, :64]
    with pytest.raises(ValueError):
        load_jax_gpt(pm.__class__(pm.config, device="cpu"), state)


def test_random_init_is_seeded():
    cfg = GPTConfig(vocab_size=64, hidden_size=128, num_layers=1,
                    num_heads=2, max_seq_len=32)
    a = GPTForPretraining(cfg, device="cpu", seed=3)
    b = GPTForPretraining(cfg, device="cpu", seed=3)
    c = GPTForPretraining(cfg, device="cpu", seed=4)
    assert torch.equal(a.gpt.wte.weight, b.gpt.wte.weight)
    assert not torch.equal(a.gpt.wte.weight, c.gpt.wte.weight)
    std = float(a.gpt.blocks[0].mlp.fc_in.weight.detach().std())
    assert abs(std - 0.02) < 0.002
    assert torch.all(a.gpt.blocks[0].ln1.weight == 1)


def test_constructor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=64, hidden_size=128, num_layers=1,
                    num_heads=2, max_seq_len=32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GPTForPretraining(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GPTForPretraining(cfg, device="cuda")
    assert GPTForPretraining(cfg, device="cpu").device.type == "cpu"
