"""Shared pieces of the ``test_torch_*`` files: seeded numpy inputs handed
to both packages, the tiny GPT both packages build, and the fixture that
skips ``cuda``-marked tests where no card is present (decided when the
test runs, never at import)."""
import numpy as np
import pytest
import torch

F32_EPS = float(np.finfo(np.float32).eps)

# the suite runs several pytest workers on a few cores: the port's tests
# work on tiny tensors and keep PyTorch's CPU thread pool small, so they
# do not starve the timing-sensitive tests running beside them
torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def paged_inputs(ctxs, kq, page=16, h=2, d=64, seed=0):
    """numpy q [B, KQ, h, d], pools, tables and lengths: row j of slot b
    sees ctxs[b] + j tokens, so a table covers ctx + kq - 1 tokens."""
    rng = np.random.default_rng(seed)
    b = len(ctxs)
    need = [(c + kq - 1 + page - 1) // page if c else 0 for c in ctxs]
    maxp = max(max(need), 1)
    npages = 1 + sum(need)
    q = rng.standard_normal((b, kq, h, d)).astype(np.float32)
    kp = rng.standard_normal((npages, page, h * d)).astype(np.float32)
    vp = rng.standard_normal((npages, page, h * d)).astype(np.float32)
    tables, nxt = [], 1
    for n in need:
        tables.append(list(range(nxt, nxt + n)) + [0] * (maxp - n))
        nxt += n
    return (q, kp, vp, np.asarray(tables, np.int32),
            np.asarray(ctxs, np.int32))


def flash_inputs(b, sq, sk, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, sk, kh, d),
                               (b, sk, kh, d)))


def jax_state(model):
    """A JAX model's weights as {name: numpy array}."""
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def tiny_models(tied=True, seed=0, max_seq_len=256):
    """The same tiny GPT (hidden 128, 2 heads of 64, 2 layers, vocab 128)
    in both packages, the port loaded with the JAX model's weights."""
    import paddle_tpu as paddle
    from paddle_tpu.text.gpt import GPTConfig as JConfig
    from paddle_tpu.text.gpt import GPTForPretraining as JGPT

    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    kw = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=max_seq_len, dropout=0.0,
              tie_word_embeddings=tied)
    paddle.seed(seed)
    jm = JGPT(JConfig(**kw))
    jm.eval()
    pm = GPTForPretraining(GPTConfig(**kw), device="cpu").eval()
    load_jax_gpt(pm, jax_state(jm))
    return jm, pm
