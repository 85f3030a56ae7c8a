"""K2, the flash-attention forward (``paddle_tpu_torch/ops/cuda_kernels.py``):
the port's plain version ``(o, lse)`` against the JAX package's
``flash_attention_with_lse`` (Pallas, interpret mode) and its dense
``_sdpa_impl``, on the same seeded numpy inputs.

Cases: causal and non-causal, GQA and MQA, non-square causal (sq=128,
sk=384, bottom-right aligned), d in {64, 128}. Tolerance: atol 2e-5 in
fp32, the JAX package's own flash-forward bound
(``tests/test_train_step_and_flash.py``).

``tests/test_torch_cuda_kernels.py`` holds the CUDA kernel against the
same plain version on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import flash_inputs
from paddle_tpu.nn.functional.attention import _sdpa_impl as jax_sdpa
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.nn.functional import attention as port_attn
from paddle_tpu_torch.ops import cuda_kernels as ck

ATOL = 2e-5

# (b, sq, sk, h, kh, d, causal, vs_kernel): every case runs against the
# JAX dense path; the interpret-mode JAX kernel (seconds per call on this
# CPU) joins where vs_kernel is set
CASES = {
    "causal": (1, 128, 128, 2, 2, 64, True, True),
    "noncausal": (2, 128, 256, 2, 2, 64, False, False),
    "gqa": (1, 128, 128, 4, 2, 64, True, True),
    "mqa": (1, 128, 128, 4, 1, 64, True, False),
    "nonsquare_causal": (1, 128, 384, 2, 2, 64, True, True),
    "d128": (1, 256, 256, 2, 2, 128, True, False),
}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_kernel_and_dense(case, interpret):
    b, sq, sk, h, kh, d, causal, vs_kernel = CASES[case]
    q, k, v = flash_inputs(b, sq, sk, h, kh, d)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o, lse = ck.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert o.shape == (b, sq, h, d) and lse.shape == (b, h, sq)
    assert lse.dtype == torch.float32
    dense = np.asarray(jax_sdpa(jq, jk, jv, None, 1.0 / math.sqrt(d),
                                causal))
    np.testing.assert_allclose(o.numpy(), dense, atol=ATOL, rtol=0)
    if vs_kernel:
        jo, jlse = pk.flash_attention_with_lse(jq, jk, jv, causal=causal)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["causal", "gqa", "nonsquare_causal"])
def test_port_dense_path_matches_plain_kernel_version(case):
    b, sq, sk, h, kh, d, causal, _ = CASES[case]
    tq, tk, tv = map(torch.from_numpy, flash_inputs(b, sq, sk, h, kh, d))
    o, _ = ck.flash_attention_reference(tq, tk, tv, causal=causal)
    dense = port_attn._sdpa_impl(tq, tk, tv, None, 1.0 / math.sqrt(d),
                                 causal)
    torch.testing.assert_close(o, dense, atol=ATOL, rtol=0)
    # the functional routes through the kernel's wrapper where the gate
    # admits the shape: on CPU tensors that is the plain version
    routed = port_attn.scaled_dot_product_attention(tq, tk, tv,
                                                    is_causal=causal)
    assert torch.equal(routed, o)


def test_gate_matches_the_jax_contract(interpret):
    shapes = [
        ((1, 128, 2, 64), (1, 128, 2, 64), False),
        ((1, 128, 4, 64), (1, 128, 2, 64), True),     # GQA
        ((1, 128, 2, 32), (1, 128, 2, 32), False),    # d not admitted
        ((1, 100, 2, 64), (1, 100, 2, 64), False),    # s % 128 != 0
        ((1, 256, 2, 64), (1, 128, 2, 64), True),     # causal, sk < sq
        ((1, 128, 3, 64), (1, 128, 2, 64), False),    # kv heads ∤ heads
        ((1, 128, 2, 64), (2, 128, 2, 64), False),    # batch mismatch
    ]
    got = [ck.flash_attention_available(torch.empty(qs), torch.empty(ks),
                                        torch.empty(ks), causal=c)
           for qs, ks, c in shapes]
    want = [pk.flash_attention_available(jnp.zeros(qs), jnp.zeros(ks),
                                         jnp.zeros(ks), causal=c)
            for qs, ks, c in shapes]
    assert got == want == [True, True] + [False] * 5


def test_short_prompts_take_the_dense_path():
    # one-token decode steps (sq = 1) are refused by the gate and run the
    # dense path, as in the JAX package
    tq, tk, tv = map(torch.from_numpy, flash_inputs(1, 1, 9, 2, 2, 64))
    assert not ck.flash_attention_available(tq, tk, tv, causal=True)
    out = port_attn.scaled_dot_product_attention(tq, tk, tv,
                                                 is_causal=True)
    torch.testing.assert_close(
        out, port_attn._sdpa_impl(tq, tk, tv, None, 1 / 8.0, True))
