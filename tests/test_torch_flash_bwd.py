"""K3, the flash-attention backward (``paddle_tpu_torch/ops/cuda_kernels.py``):
the port's plain version ``flash_attention_bwd_reference`` against
``jax.vjp`` of the JAX package's ``flash_attention_with_lse`` (Pallas
forward and fused backward, interpret mode), with cotangents on both o
and lse, on the same seeded numpy inputs.

Cases: causal and non-causal, GQA and MQA, non-square causal (sq=128,
sk=384, bottom-right aligned), d=128, and a non-zero lse cotangent.
Tolerance: atol 5e-5 in fp32, and 2e-4 where kv heads are shared (GQA,
MQA): the JAX package's own bounds for its flash backward
(``tests/test_train_step_and_flash.py``); the shared-head gradients sum
more terms. The plain K3 is also held against torch autograd of the
dense fp32 path, and the autograd function against the plain K3. In
bf16, the training path's dtype, the plain K3 is held against the JAX
kernel in bf16, and in fp16, eager AMP O2's dtype, against the JAX kernel
in fp16, with the bounds stated at those tests.

``tests/test_torch_cuda_kernels.py`` holds the CUDA kernel against the
same plain version on the card.
"""
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import flash_inputs
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.nn.functional import attention as port_attn
from paddle_tpu_torch.ops import cuda_kernels as ck

# (b, sq, sk, h, kh, d, causal, lse cotangent)
CASES = {
    "causal": (1, 128, 128, 2, 2, 64, True, False),
    "noncausal": (2, 128, 256, 2, 2, 64, False, False),
    "gqa": (1, 128, 128, 4, 2, 64, True, False),
    "mqa": (1, 128, 128, 4, 1, 64, True, False),
    "nonsquare_causal": (1, 128, 384, 2, 2, 64, True, False),
    "d128": (1, 128, 128, 2, 2, 128, True, False),
    "dlse": (1, 128, 256, 2, 2, 64, True, True),
}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "1")


def _cotangents(case, seed=1):
    b, sq, _, h, _, d, _, with_dlse = CASES[case]
    rng = np.random.default_rng(seed)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    dlse = rng.standard_normal((b, h, sq)).astype(np.float32) if with_dlse \
        else np.zeros((b, h, sq), np.float32)
    return do, dlse


def _tol(case):
    b, sq, sk, h, kh, d, causal, _ = CASES[case]
    return 2e-4 if kh != h else 5e-5


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_kernel(case, interpret):
    b, sq, sk, h, kh, d, causal, _ = CASES[case]
    q, k, v = flash_inputs(b, sq, sk, h, kh, d)
    do, dlse = _cotangents(case)
    (jo, jlse), vjp = jax.vjp(
        lambda q_, k_, v_: pk.flash_attention_with_lse(q_, k_, v_,
                                                       causal=causal),
        *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = ck.flash_attention_reference(tq, tk, tv, causal=causal)
    got = ck.flash_attention_bwd_reference(
        tq, tk, tv, o, lse, torch.from_numpy(do), torch.from_numpy(dlse),
        causal=causal)
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=_tol(case),
                                   rtol=0, err_msg=f"d{name}")


def _bf16_ulp(x):
    """The spacing of bf16 values at magnitude x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("case", ["causal", "gqa", "nonsquare_causal",
                                  "dlse"])
def test_plain_backward_matches_jax_kernel_in_bf16(case, interpret):
    """The plain K3 in bf16 (what the card's bf16 kernel is held against)
    against ``jax.vjp`` of the JAX kernels in bf16, from the JAX forward's
    own o and lse and the same bf16 cotangents. Within two ulps at the
    outputs' largest magnitude: both round dq, dk and dv once (half an
    ulp each), and the JAX kernel also rounds the scaled q, p and ds to
    bf16 (each off by at most 2**-9 of itself) where the plain version
    keeps fp32."""
    b, sq, sk, h, kh, d, causal, _ = CASES[case]
    q, k, v = (x.astype(jnp.bfloat16).astype(np.float32)
               for x in flash_inputs(b, sq, sk, h, kh, d))
    do, dlse = _cotangents(case)
    do = do.astype(jnp.bfloat16).astype(np.float32)
    (jo, jlse), vjp = jax.vjp(
        lambda q_, k_, v_: pk.flash_attention_with_lse(q_, k_, v_,
                                                       causal=causal),
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = [np.asarray(w.astype(jnp.float32)) for w in
            vjp((jnp.asarray(do, jnp.bfloat16), jnp.asarray(dlse)))]
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(
        torch.bfloat16)
    got = ck.flash_attention_bwd_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), to,
        torch.from_numpy(np.array(jlse)),
        torch.from_numpy(do).to(torch.bfloat16), torch.from_numpy(dlse),
        causal=causal)
    tol = 2 * _bf16_ulp(max(np.abs(w).max() for w in want))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["causal", "gqa", "nonsquare_causal",
                                  "dlse"])
def test_plain_backward_matches_jax_kernel_in_fp16(case, interpret):
    """The plain K3 in fp16 (what the card's fp16 kernel is held against)
    against ``jax.vjp`` of the JAX kernels in fp16: the bf16 test's bound
    in fp16's units, two ulps (11 significant bits) at the outputs'
    largest magnitude."""
    b, sq, sk, h, kh, d, causal, _ = CASES[case]
    q, k, v = (x.astype(np.float16).astype(np.float32)
               for x in flash_inputs(b, sq, sk, h, kh, d))
    do, dlse = _cotangents(case)
    do = do.astype(np.float16).astype(np.float32)
    (jo, jlse), vjp = jax.vjp(
        lambda q_, k_, v_: pk.flash_attention_with_lse(q_, k_, v_,
                                                       causal=causal),
        *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    want = [np.asarray(w.astype(jnp.float32)) for w in
            vjp((jnp.asarray(do, jnp.float16), jnp.asarray(dlse)))]
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(
        torch.float16)
    got = ck.flash_attention_bwd_reference(
        *(torch.from_numpy(x).to(torch.float16) for x in (q, k, v)), to,
        torch.from_numpy(np.array(jlse)),
        torch.from_numpy(do).to(torch.float16), torch.from_numpy(dlse),
        causal=causal)
    top = max(np.abs(w).max() for w in want)
    tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 10)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float16 and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["causal", "gqa", "nonsquare_causal",
                                  "dlse"])
def test_plain_backward_matches_dense_autograd(case):
    b, sq, sk, h, kh, d, causal, _ = CASES[case]
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in flash_inputs(b, sq, sk, h, kh, d))
    do, dlse = map(torch.from_numpy, _cotangents(case))
    scale = 1.0 / math.sqrt(d)
    # the dense path: o by the port's _sdpa_impl, lse recomputed densely
    o = port_attn._sdpa_impl(q, k, v, None, scale, causal)
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale,
                     k.repeat_interleave(h // kh, dim=2))
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    want = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(),
                               (q, k, v))
    with torch.no_grad():
        po, plse = ck.flash_attention_reference(q, k, v, causal=causal)
        got = ck.flash_attention_bwd_reference(q, k, v, po, plse, do, dlse,
                                               causal=causal)
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g, w, atol=_tol(case), rtol=0,
                                   msg=f"d{name}")


@pytest.mark.parametrize("case", ["causal", "mqa", "dlse"])
def test_autograd_function_runs_the_plain_backward_on_cpu(case,
                                                          monkeypatch):
    b, sq, sk, h, kh, d, causal, _ = CASES[case]
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in flash_inputs(b, sq, sk, h, kh, d))
    do, dlse = map(torch.from_numpy, _cotangents(case))
    calls = []
    real = ck.flash_attention_bwd

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ck, "flash_attention_bwd", spy)
    o, lse = ck.flash_attention_with_lse(q, k, v, causal=causal)
    got = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(),
                              (q, k, v))
    assert calls == [q.shape]
    with torch.no_grad():
        want = ck.flash_attention_bwd_reference(q, k, v, o, lse, do, dlse,
                                                causal=causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_values_backward_is_the_zero_lse_cotangent_case():
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in flash_inputs(1, 128, 128, 2, 2, 64))
    do = torch.from_numpy(_cotangents("causal")[0])
    got = torch.autograd.grad(
        (ck.flash_attention_values(q, k, v, causal=True) * do).sum(),
        (q, k, v))
    with torch.no_grad():
        o, lse = ck.flash_attention_reference(q, k, v, causal=True)
        want = ck.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                                causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "route,d", [pytest.param("fp32", d, id=str(d)) for d in (64, 128, 256)]
    + [pytest.param("bf16", d, id=f"bf16-{d}") for d in (64, 128, 256)])
def test_backward_shared_memory_fits_a_block(route, d):
    # the kernel's note states each pass's tiles per d and route. fp32
    # (64-row tiles, 32 at d = 256): dk/dv four [r, d + 1] operand tiles,
    # two [r, r + 1] score tiles and two [r] statistics; dq four operand
    # tiles and one score tile. bf16: dk/dv the 64-row k and v tiles and
    # two stages of [m, d] q and do tiles (m = 64 at d = 64, else 32) and
    # of [m] lse and delta rows; dq the 64-row q and do tiles and two
    # stages of [n, d] k and v tiles (n = 32 at d = 256, else 64). Both
    # fit the 232,448 bytes a block can opt into.
    if route == "fp32":
        r = 32 if d == 256 else 64
        dkdv = 4 * (4 * r * (d + 1) + 2 * r * (r + 1) + 2 * r)
        dq = 4 * (4 * r * (d + 1) + r * (r + 1))
    else:
        m, n = (64 if d == 64 else 32), (32 if d == 256 else 64)
        dkdv = 2 * (2 * 64 * d + 4 * m * d) + 4 * 4 * m
        dq = 2 * (2 * 64 * d + 4 * n * d)
    assert max(dkdv, dq) <= 232448
    note = (Path(ck.__file__).parents[1] / "csrc" / "flash_bwd.cu") \
        .read_text()
    assert f"{dkdv:,}" in note and f"{dq:,}" in note
