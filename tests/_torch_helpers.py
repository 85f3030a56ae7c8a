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


def paged_tols(dtype, max_ctx, kq, v_pages):
    """(atol, rtol) of K1 against its plain version on the same inputs,
    in fp32 (16-bit inputs widen exactly): fp32 at K*eps, K the longest
    context plus KQ (fp32 sums over K terms); bf16 and fp16 element by
    element at atol K*eps*max|v| and rtol of half an ulp of the output,
    which is rounded once: 2**-8 for bf16, 2**-11 (fp16's eps) for fp16."""
    k_eps = (max_ctx + kq) * F32_EPS
    if dtype == torch.float32:
        return k_eps, k_eps
    half_ulp = 2 ** -11 if dtype == torch.float16 else 2 ** -8
    return k_eps * float(v_pages.float().abs().max()), half_ulp


def paged_inputs(ctxs, kq, page=16, h=2, d=64, seed=0, spare=0):
    """numpy q [B, KQ, h, d], pools, tables and lengths: row j of slot b
    sees ctxs[b] + j tokens, so a table covers ctx + kq - 1 tokens, and
    an active slot's table holds ``spare`` more pages of random rows past
    that."""
    rng = np.random.default_rng(seed)
    b = len(ctxs)
    need = [(c + kq - 1 + page - 1) // page + spare if c else 0
            for c in ctxs]
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


def varlen_inputs(lengths_q, lengths_k=None, h=2, d=64, seed=0):
    """numpy q [Tq, h, d], k/v [Tk, h, d] and int32 cu_seqlens for
    sequences packed end to end; k takes q's lengths when none are
    given."""
    lengths_k = lengths_q if lengths_k is None else lengths_k
    rng = np.random.default_rng(seed)
    tq, tk = int(sum(lengths_q)), int(sum(lengths_k))
    q = rng.standard_normal((tq, h, d)).astype(np.float32)
    k = rng.standard_normal((tk, h, d)).astype(np.float32)
    v = rng.standard_normal((tk, h, d)).astype(np.float32)
    cu = [np.concatenate([[0], np.cumsum(n)]).astype(np.int32)
          for n in (lengths_q, lengths_k)]
    return q, k, v, cu[0], cu[1]


def jax_state(model):
    """A JAX model's weights as {name: numpy array}."""
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def tiny_models(tied=True, seed=0, max_seq_len=256, use_rmsnorm=False):
    """The same tiny GPT (hidden 128, 2 heads of 64, 2 layers, vocab 128)
    in both packages, the port loaded with the JAX model's weights."""
    import paddle_tpu as paddle
    from paddle_tpu.text.gpt import GPTConfig as JConfig
    from paddle_tpu.text.gpt import GPTForPretraining as JGPT

    from paddle_tpu_torch.convert import load_jax_gpt
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    kw = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=max_seq_len, dropout=0.0,
              tie_word_embeddings=tied, use_rmsnorm=use_rmsnorm)
    paddle.seed(seed)
    jm = JGPT(JConfig(**kw))
    jm.eval()
    pm = GPTForPretraining(GPTConfig(**kw), device="cpu").eval()
    load_jax_gpt(pm, jax_state(jm))
    return jm, pm


# the tiny encoder both packages build for the ERNIE and BERT tests:
# hidden 128, 2 heads of 64, 2 layers; batches of 2 x 128 tokens, so the
# port's unmasked attention takes the kernel route (the plain K2/K3 on
# the CPU)
TINY_ENCODER = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    max_position_embeddings=128, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)


def tiny_text_models(family, head, seed=0, **head_kw):
    """The same tiny ``family`` ("ernie" or "bert") model with the head
    class ``head`` in both packages, in eval mode, the port loaded with
    the JAX model's weights."""
    import importlib

    import paddle_tpu as paddle

    from paddle_tpu_torch.convert import load_jax_state
    jmod = importlib.import_module(f"paddle_tpu.text.{family}")
    pmod = importlib.import_module(f"paddle_tpu_torch.text.{family}")
    config = f"{family.capitalize()}Config"
    paddle.seed(seed)
    jm = getattr(jmod, head)(getattr(jmod, config)(**TINY_ENCODER),
                             **head_kw)
    jm.eval()
    pm = getattr(pmod, head)(getattr(pmod, config)(**TINY_ENCODER),
                             device="cpu", **head_kw).eval()
    load_jax_state(pm, jax_state(jm))
    return jm, pm


def token_batch(seed, k=None, vocab=TINY_ENCODER["vocab_size"],
                ignored=0.5):
    """(ids, labels) of shape [2, 128] (or [k, 2, 128]) from
    ``numpy.random.default_rng(seed)``; about ``ignored`` of the labels
    are -100."""
    rng = np.random.default_rng(seed)
    shape = (2, 128) if k is None else (k, 2, 128)
    ids = rng.integers(0, vocab, shape)
    labels = rng.integers(0, vocab, shape)
    labels[rng.random(shape) < ignored] = -100
    return ids, labels
