"""K2, the flash-attention forward (``paddle_tpu_torch/ops/cuda_kernels.py``):
the port's plain version ``(o, lse)`` against the JAX package's
``flash_attention_with_lse`` (Pallas, interpret mode) and its dense
``_sdpa_impl``, on the same seeded numpy inputs.

Cases: causal and non-causal, GQA and MQA, non-square causal (sq=128,
sk=384, bottom-right aligned), d in {64, 128}. Tolerance: atol 2e-5 in
fp32, the JAX package's own flash-forward bound
(``tests/test_train_step_and_flash.py``). The plain version is also held
in bf16, the training path's dtype, against the JAX kernel in bf16, and
in fp16, eager AMP O2's dtype, against the JAX kernel in fp16, with the
bounds stated at those tests.

``tests/test_torch_cuda_kernels.py`` holds the CUDA kernel against the
same plain version on the card.
"""
import math
from pathlib import Path

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


def _bf16_ulp(x):
    """The spacing of bf16 values at magnitude x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("case", ["causal", "noncausal", "gqa",
                                  "nonsquare_causal"])
def test_plain_matches_jax_kernel_in_bf16(case, interpret):
    """The plain K2 in bf16 (what the card's bf16 kernel is held against)
    against the JAX kernel in bf16, on the seeded inputs rounded to bf16
    alike. o within two ulps at its largest magnitude: both round o once
    (half an ulp each), and the JAX kernel also rounds the scaled q and p
    to bf16 (each off by at most 2**-9 of itself) where the plain version
    keeps fp32. lse within the largest move those roundings can make: the
    scaled q moves a score by at most 2**-9 * sm_scale * sum_d |q k|, and
    the row sum the JAX kernel takes over the bf16 p by at most 2**-9 of
    itself, 2**-9 in lse."""
    b, sq, sk, h, kh, d, causal, _ = CASES[case]
    q, k, v = (x.astype(jnp.bfloat16).astype(np.float32)
               for x in flash_inputs(b, sq, sk, h, kh, d))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = ck.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    jo, jlse = pk.flash_attention_with_lse(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal)
    assert jo.dtype == jnp.bfloat16
    jo = np.asarray(jo.astype(jnp.float32))
    np.testing.assert_allclose(o.float().numpy(), jo, rtol=0,
                               atol=2 * _bf16_ulp(np.abs(jo).max()))
    qk = np.einsum("bqhd,bkhd->bhqk", np.abs(q),
                   np.abs(np.repeat(k, h // kh, axis=2)))
    lse_tol = 2.0 ** -9 * (qk.max() / math.sqrt(d) + 1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=lse_tol)


def _fp16_ulp(x):
    """The spacing of fp16 values at magnitude x (11 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 10)


@pytest.mark.parametrize("case", ["causal", "noncausal", "gqa",
                                  "nonsquare_causal"])
def test_plain_matches_jax_kernel_in_fp16(case, interpret):
    """The plain K2 in fp16 (what the card's fp16 kernel is held against)
    against the JAX kernel in fp16, on the seeded inputs rounded to fp16
    alike: the bf16 test's bounds in fp16's units (o within two ulps at its
    largest magnitude; the JAX kernel's fp16 scaled q and p are each off
    by at most 2**-11 of themselves, which bounds lse)."""
    b, sq, sk, h, kh, d, causal, _ = CASES[case]
    q, k, v = (x.astype(np.float16).astype(np.float32)
               for x in flash_inputs(b, sq, sk, h, kh, d))
    tq, tk, tv = (torch.from_numpy(x).to(torch.float16) for x in (q, k, v))
    o, lse = ck.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    jo, jlse = pk.flash_attention_with_lse(
        *(jnp.asarray(x, jnp.float16) for x in (q, k, v)), causal=causal)
    assert jo.dtype == jnp.float16
    jo = np.asarray(jo.astype(jnp.float32))
    np.testing.assert_allclose(o.float().numpy(), jo, rtol=0,
                               atol=2 * _fp16_ulp(np.abs(jo).max()))
    qk = np.einsum("bqhd,bkhd->bhqk", np.abs(q),
                   np.abs(np.repeat(k, h // kh, axis=2)))
    lse_tol = 2.0 ** -11 * (qk.max() / math.sqrt(d) + 1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=lse_tol)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_forward_shared_memory_fits_a_block(d):
    # the bf16 route's note states its tiles per d: a 64-row q tile and two
    # stages of k and v tiles of n rows (128, 64 and 32 at d = 64, 128 and
    # 256), all bf16
    n = {64: 128, 128: 64, 256: 32}[d]
    smem = 2 * (64 * d + 4 * n * d)
    assert smem <= 232448
    note = (Path(ck.__file__).parents[1] / "csrc" / "flash_fwd.cu") \
        .read_text()
    assert f"{smem:,} bytes" in note


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
