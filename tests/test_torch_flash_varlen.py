"""K4 and K5, packed varlen attention (``paddle_tpu_torch/ops/cuda_kernels.py``):
the port's plain versions ``flash_attention_varlen_reference`` and
``flash_attention_varlen_bwd_reference``, its dense ``_unpadded_impl`` and
its ``flash_attn_unpadded`` route, held against the JAX package on the
same seeded numpy inputs: the Pallas varlen kernels in interpret mode
(``flash_attention_varlen_values`` forward and ``jax.grad`` through its
custom vjp) and the JAX ``_unpadded_impl``.

Tolerances against the JAX package are its own bounds for its varlen
kernels (``tests/test_varlen_flash.py``): rtol and atol 2e-5 on outputs
in fp32, rtol and atol 2e-4 on gradients; the fp16 cases at the bf16
cases' bounds in fp16's ulps; the bf16 case at one bf16 ulp
of the largest output. Port against port (plain versions, dense path)
is held to the absolute bounds alone. The tile ranges the CUDA kernels walk are checked here
too: every visible (q, kv) pair lies inside them.

``tests/test_torch_cuda_kernels.py`` holds the CUDA kernels against the
same plain versions on the card.
"""
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from _torch_helpers import varlen_inputs
from paddle_tpu.nn.functional.attention import _unpadded_impl as jax_unpadded
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import cuda_kernels as ck

# q lengths; totals 510 (pads in JAX), 512 and 512
LENGTHS = {"pads": [100, 260, 150], "aligned": [128, 128, 256],
           "one_token": [1, 300, 211]}
FWD_TOL, GRAD_TOL = 2e-5, 2e-4
# the JAX package's assert_allclose bounds for its varlen kernels
JAX_FWD = dict(atol=FWD_TOL, rtol=FWD_TOL)
JAX_GRAD = dict(atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "1")


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _do(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _jax_kernel_grads(q, k, v, cu_q, cu_k, do, causal):
    scale = 1.0 / math.sqrt(q.shape[-1])
    jcu_q, jcu_k = _jax(cu_q, cu_k)

    def loss(q_, k_, v_):
        o = pk.flash_attention_varlen_values(q_, k_, v_, jcu_q, jcu_k, scale,
                                             causal=causal)
        return jnp.sum(o * jnp.asarray(do))

    return jax.grad(loss, argnums=(0, 1, 2))(*_jax(q, k, v))


CASES = [(name, causal, 64) for name in LENGTHS for causal in (False, True)]
CASES.append(("pads", True, 128))


@pytest.mark.parametrize("name,causal,d", CASES)
def test_plain_forward_matches_jax_kernel(name, causal, d, interpret):
    q, k, v, cu, _ = varlen_inputs(LENGTHS[name], d=d)
    scale = 1.0 / math.sqrt(d)
    want = pk.flash_attention_varlen_values(*_jax(q, k, v, cu, cu), scale,
                                            causal=causal)
    tq, tk, tv, tcu = _torch(q, k, v, cu)
    o, lse = ck.flash_attention_varlen_reference(tq, tk, tv, tcu, tcu,
                                                 causal)
    assert o.shape == tq.shape and o.dtype == torch.float32
    assert lse.shape == (2, tq.shape[0]) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **JAX_FWD)


@pytest.mark.parametrize("name,causal,d", CASES)
def test_plain_forward_matches_jax_dense(name, causal, d):
    q, k, v, cu, _ = varlen_inputs(LENGTHS[name], d=d)
    scale = 1.0 / math.sqrt(d)
    n = max(LENGTHS[name])
    want = jax_unpadded(*_jax(q, k, v, cu, cu), scale, causal, n, n)
    tq, tk, tv, tcu = _torch(q, k, v, cu)
    o, lse = ck.flash_attention_varlen_reference(tq, tk, tv, tcu, tcu,
                                                 causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **JAX_FWD)
    # lse is the natural-log logsumexp of each row's visible scores
    dense = F._unpadded_impl(tq, tk, tv, tcu, tcu, scale, causal, n, n)
    torch.testing.assert_close(o, dense, atol=FWD_TOL, rtol=0)
    seg = ck._segment_ids(tcu, tq.shape[0])
    s = torch.einsum("qhd,khd->hqk", tq * scale, tk)
    keep = seg[:, None] == seg[None, :]
    if causal:
        keep &= torch.ones_like(keep).tril()
    want_lse = torch.logsumexp(s.masked_fill(~keep, float("-inf")), -1)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)


def test_plain_forward_bf16_matches_jax_kernel(interpret):
    q, k, v, cu, _ = varlen_inputs(LENGTHS["pads"])
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(pk.flash_attention_varlen_values(
        qb, kb, vb, jnp.asarray(cu), jnp.asarray(cu), 0.125, causal=True),
        np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32))
                  .to(torch.bfloat16) for x in (qb, kb, vb))
    tcu = torch.from_numpy(cu)
    o, _ = ck.flash_attention_varlen_reference(tq, tk, tv, tcu, tcu, True)
    assert o.dtype == torch.bfloat16
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(o.float().numpy(), want, atol=ulp, rtol=0)


def test_plain_forward_fp16_matches_jax_kernel(interpret):
    # the bf16 case's bound in fp16's units: one ulp at the largest |o|
    q, k, v, cu, _ = varlen_inputs(LENGTHS["pads"])
    qh, kh, vh = (jnp.asarray(x, jnp.float16) for x in (q, k, v))
    want = np.asarray(pk.flash_attention_varlen_values(
        qh, kh, vh, jnp.asarray(cu), jnp.asarray(cu), 0.125, causal=True),
        np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32))
                  .to(torch.float16) for x in (qh, kh, vh))
    tcu = torch.from_numpy(cu)
    o, _ = ck.flash_attention_varlen_reference(tq, tk, tv, tcu, tcu, True)
    assert o.dtype == torch.float16
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 10)
    np.testing.assert_allclose(o.float().numpy(), want, atol=ulp, rtol=0)


@pytest.mark.parametrize("name,causal,d", CASES)
def test_plain_backward_matches_jax_kernel_grad(name, causal, d, interpret):
    q, k, v, cu, _ = varlen_inputs(LENGTHS[name], d=d)
    do = _do(q.shape)
    want = _jax_kernel_grads(q, k, v, cu, cu, do, causal)
    tq, tk, tv, tcu, tdo = _torch(q, k, v, cu, do)
    o, lse = ck.flash_attention_varlen_reference(tq, tk, tv, tcu, tcu,
                                                 causal)
    got = ck.flash_attention_varlen_bwd_reference(tq, tk, tv, o, lse, tdo,
                                                  tcu, tcu, causal)
    for nm, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX_GRAD,
                                   err_msg=f"d{nm}")


def _bf16_ulp(x):
    """The spacing of bf16 values at magnitude x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("name,causal", [("pads", True), ("pads", False),
                                         ("one_token", True)])
def test_plain_backward_bf16_matches_jax_kernel_grad(name, causal,
                                                     interpret):
    """The plain K5 in bf16 (what the card's bf16 kernel is held against)
    against ``jax.vjp`` of the JAX varlen kernels in bf16, on the same
    bf16 inputs and cotangent. The plain version takes the JAX forward's
    own bf16 o (for delta) and the plain forward's fp32 lse (the JAX lse
    stays inside its custom vjp). Within two ulps at the outputs' largest
    magnitude: both round dq, dk and dv once (half an ulp each), and the
    JAX kernel also rounds the scaled q, p and ds to bf16 (each off by at
    most 2**-9 of itself) where the plain version keeps fp32."""
    q, k, v, cu, _ = varlen_inputs(LENGTHS[name])
    q, k, v = (x.astype(jnp.bfloat16).astype(np.float32) for x in (q, k, v))
    do = _do(q.shape).astype(jnp.bfloat16).astype(np.float32)
    jcu = jnp.asarray(cu)
    jo, vjp = jax.vjp(
        lambda q_, k_, v_: pk.flash_attention_varlen_values(
            q_, k_, v_, jcu, jcu, 0.125, causal=causal),
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = [np.asarray(w.astype(jnp.float32))
            for w in vjp(jnp.asarray(do, jnp.bfloat16))]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    tcu = torch.from_numpy(cu)
    _, lse = ck.flash_attention_varlen_reference(tq, tk, tv, tcu, tcu,
                                                 causal, 0.125)
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(
        torch.bfloat16)
    got = ck.flash_attention_varlen_bwd_reference(tq, tk, tv, to, lse, tdo,
                                                  tcu, tcu, causal, 0.125)
    tol = 2 * _bf16_ulp(max(np.abs(w).max() for w in want))
    for nm, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol, rtol=0,
                                   err_msg=f"d{nm}")


@pytest.mark.parametrize("name,causal", [("pads", True), ("pads", False),
                                         ("one_token", True)])
def test_plain_backward_fp16_matches_jax_kernel_grad(name, causal,
                                                     interpret):
    """The plain K5 in fp16 against ``jax.vjp`` of the JAX varlen kernels
    in fp16: the bf16 test's bound in fp16's units, two ulps (11
    significant bits) at the outputs' largest magnitude."""
    q, k, v, cu, _ = varlen_inputs(LENGTHS[name])
    q, k, v = (x.astype(np.float16).astype(np.float32) for x in (q, k, v))
    do = _do(q.shape).astype(np.float16).astype(np.float32)
    jcu = jnp.asarray(cu)
    jo, vjp = jax.vjp(
        lambda q_, k_, v_: pk.flash_attention_varlen_values(
            q_, k_, v_, jcu, jcu, 0.125, causal=causal),
        *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    want = [np.asarray(w.astype(jnp.float32))
            for w in vjp(jnp.asarray(do, jnp.float16))]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.float16)
                       for x in (q, k, v, do))
    tcu = torch.from_numpy(cu)
    _, lse = ck.flash_attention_varlen_reference(tq, tk, tv, tcu, tcu,
                                                 causal, 0.125)
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(
        torch.float16)
    got = ck.flash_attention_varlen_bwd_reference(tq, tk, tv, to, lse, tdo,
                                                  tcu, tcu, causal, 0.125)
    top = max(np.abs(w).max() for w in want)
    tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 10)
    for nm, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float16 and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol, rtol=0,
                                   err_msg=f"d{nm}")


@pytest.mark.parametrize("name,causal,d", CASES)
def test_plain_backward_matches_autograd_of_dense(name, causal, d):
    q, k, v, cu, _ = varlen_inputs(LENGTHS[name], d=d)
    tq, tk, tv = (x.requires_grad_(True) for x in _torch(q, k, v))
    tcu, tdo = _torch(cu, _do(q.shape))
    scale = 1.0 / math.sqrt(d)
    n = max(LENGTHS[name])
    dense = F._unpadded_impl(tq, tk, tv, tcu, tcu, scale, causal, n, n)
    want = torch.autograd.grad(dense, (tq, tk, tv), tdo)
    with torch.no_grad():
        o, lse = ck.flash_attention_varlen_reference(tq, tk, tv, tcu, tcu,
                                                     causal)
        got = ck.flash_attention_varlen_bwd_reference(tq, tk, tv, o, lse, tdo,
                                                      tcu, tcu, causal)
    for nm, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g, w, atol=GRAD_TOL, rtol=0,
                                   msg=f"d{nm}")


def test_cross_attention_ragged_q_grads_finite_and_matching(interpret):
    # Tq = 423 pads to 512 in JAX while Tk = 512 does not: JAX's pad q rows
    # see a non-empty kv range with every column masked (the case the
    # backward's exp(min(s - lse, 0)) guard exists for)
    lq, lk = [1, 97, 240, 85], [128] * 4
    q, k, v, cu_q, cu_k = varlen_inputs(lq, lk, seed=4)
    do = _do(q.shape, seed=5)
    want = _jax_kernel_grads(q, k, v, cu_q, cu_k, do, False)
    want_o = pk.flash_attention_varlen_values(*_jax(q, k, v, cu_q, cu_k),
                                              0.125, causal=False)
    tq, tk, tv = (x.requires_grad_(True) for x in _torch(q, k, v))
    tcu_q, tcu_k, tdo = _torch(cu_q, cu_k, do)
    out, _ = F.flash_attn_unpadded(tq, tk, tv, tcu_q, tcu_k, max(lq),
                                   max(lk))
    got = torch.autograd.grad(out, (tq, tk, tv), tdo)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               **JAX_FWD)
    for nm, g, w in zip("qkv", got, want):
        assert torch.isfinite(g).all(), f"d{nm} not finite"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX_GRAD,
                                   err_msg=f"d{nm}")


def test_no_cross_segment_leakage():
    # scaling one sequence's values must not move any other's outputs
    lengths = [112, 160, 96]
    q, k, v, cu, _ = varlen_inputs(lengths, seed=5)
    tq, tk, tv, tcu = _torch(q, k, v, cu)
    base, _ = F.flash_attn_unpadded(tq, tk, tv, tcu, tcu, 160, 160)
    tv2 = tv.clone()
    tv2[cu[1]:cu[2]] *= 100.0
    out, _ = F.flash_attn_unpadded(tq, tk, tv2, tcu, tcu, 160, 160)
    assert torch.equal(out[:cu[1]], base[:cu[1]])
    assert torch.equal(out[cu[2]:], base[cu[2]:])
    assert (out[cu[1]:cu[2]] - base[cu[1]:cu[2]]).abs().max() > 1.0


def test_row_that_sees_no_key_writes_positive_zero():
    # an empty k segment: its q rows see nothing. The port writes +0 and
    # lse -1e30; the JAX kernel's value there depends on its tile size
    q, k, v, cu_q, cu_k = varlen_inputs([40, 90, 33], [50, 0, 77])
    tq, tk, tv, tcu_q, tcu_k = _torch(q, k, v, cu_q, cu_k)
    o, lse = ck.flash_attention_varlen_reference(tq, tk, tv, tcu_q, tcu_k)
    rows = slice(40, 130)
    assert torch.equal(o[rows], torch.zeros_like(o[rows]))
    assert not torch.signbit(o[rows]).any()
    assert torch.all(lse[:, rows] == -1e30)
    assert torch.isfinite(o).all() and bool((o[:40] != 0).any())
    do = torch.from_numpy(_do(q.shape))
    grads = ck.flash_attention_varlen_bwd_reference(tq, tk, tv, o, lse, do,
                                                    tcu_q, tcu_k)
    assert torch.equal(grads[0][rows], torch.zeros_like(grads[0][rows]))
    assert all(torch.isfinite(g).all() for g in grads)


def _route(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("kind", ["kernel_causal", "kernel_cross",
                                  "dropout", "causal_unequal_cu"])
def test_functional_routes_as_the_jax_package(kind, monkeypatch, interpret):
    lq = [100, 260, 150]
    lk = {"kernel_cross": [200, 110, 200],
          "causal_unequal_cu": [120, 240, 150]}.get(kind, lq)
    q, k, v, cu_q, cu_k = varlen_inputs(lq, lk, seed=2)
    causal = kind != "kernel_cross"
    dropout = 0.5 if kind == "dropout" else 0.0
    jax_calls = _route(monkeypatch, pk, "flash_attention_varlen_values")
    port_calls = _route(monkeypatch, ck, "flash_attention_varlen_values")
    want, _ = JF.flash_attn_unpadded(
        *(paddle.to_tensor(x) for x in (q, k, v, cu_q, cu_k)), max(lq),
        max(lk), dropout=dropout, causal=causal)
    tq, tk, tv, tcu_q, tcu_k = _torch(q, k, v, cu_q, cu_k)
    got, none = F.flash_attn_unpadded(tq, tk, tv, tcu_q, tcu_k, max(lq),
                                      max(lk), dropout=dropout,
                                      causal=causal)
    assert none is None
    kernel = kind.startswith("kernel")
    assert bool(jax_calls) == kernel and bool(port_calls) == kernel
    np.testing.assert_allclose(got.numpy(), want.numpy(), **JAX_FWD)
    if kind == "causal_unequal_cu":
        # the dense route's causal mask is per segment and top-left
        # aligned: row i of segment s sees keys 0..i of segment s
        n = cu_q[1] - cu_q[0]
        seg0 = torch.softmax(
            torch.einsum("qhd,khd->hqk", tq[:n], tk[:cu_k[1]]) * 0.125
            + torch.full((n, int(cu_k[1])), float("-inf")).triu(1), -1)
        torch.testing.assert_close(
            got[:n], torch.einsum("hqk,khd->qhd", seg0, tv[:cu_k[1]]),
            atol=FWD_TOL, rtol=0)


def _gate_table():
    t, h, d = 256, 2, 64
    cu = np.asarray([0, 100, 256], np.int32)
    other = np.asarray([0, 128, 256], np.int32)
    rows = [  # (q shape, k shape, v shape, cu_k: same/equal/other, causal)
        ((t, h, d), (t, h, d), (t, h, d), "same", True),
        ((t, h, d), (t, h, d), (t, h, d), "equal", True),
        ((t, h, d), (t, h, d), (t, h, d), "other", True),
        ((t, h, d), (t, h, d), (t, h, d), "other", False),
        ((t, h, 128), (t, h, 128), (t, h, 128), "same", True),
        ((t, h, 256), (384, h, 256), (384, h, 256), "other", False),
        ((t, h, 32), (t, h, 32), (t, h, 32), "same", False),
        ((t, h, 80), (t, h, 80), (t, h, 80), "same", False),
        ((t, h, d), (t, 1, d), (t, 1, d), "same", False),
        ((t, h, d), (t, h, d), (t, h, 128), "same", False),
        ((t, h, d), (128, h, d), (t, h, d), "same", False),
        ((1, t, h, d), (1, t, h, d), (1, t, h, d), "same", False),
        ((100, h, d), (t, h, d), (t, h, d), "other", False),
    ]
    for qs, ks, vs, which, causal in rows:
        cu_k = {"same": cu, "equal": cu.copy(), "other": other}[which]
        yield qs, ks, vs, cu, cu_k, which, causal


@pytest.mark.parametrize("row", list(_gate_table()),
                         ids=lambda r: f"{r[0]}-{r[1]}-{r[5]}-causal{r[6]}")
def test_gate_agrees_with_the_jax_gate(row, interpret):
    qs, ks, vs, cu_q, cu_k, which, causal = row
    arrays = [np.zeros(s, np.float32) for s in (qs, ks, vs)]
    jq, jk, jv = _jax(*arrays)
    jcu_q = jnp.asarray(cu_q)
    jcu_k = jcu_q if which == "same" else jnp.asarray(cu_k)
    want = pk.flash_attention_varlen_available(jq, jk, jv, jcu_q, jcu_k,
                                               causal)
    tq, tk, tv = _torch(*arrays)
    tcu_q = torch.from_numpy(cu_q)
    tcu_k = tcu_q if which == "same" else torch.from_numpy(cu_k)
    assert ck.flash_attention_varlen_available(tq, tk, tv, tcu_q, tcu_k,
                                               causal) == want


def test_gate_sees_cu_changed_in_place(interpret):
    # a cu buffer reused with new values: the cached verdict is keyed on
    # each tensor's version as well as its identity, so the gate compares
    # again and routes as the JAX package does on the new values
    from paddle_tpu_torch.nn.functional.attention import _unpadded_impl
    q, k, v, cu_q, _ = varlen_inputs([100, 260, 150], seed=3)
    other = np.asarray([0, 120, 380, 510], np.int32)
    tq, tk, tv, tcu_q = _torch(q, k, v, cu_q)
    tcu_k = tcu_q.clone()
    assert ck.flash_attention_varlen_available(tq, tk, tv, tcu_q, tcu_k,
                                               True)
    assert any(e[0]() is tcu_q and e[1]() is tcu_k and e[3]
               for e in ck._CU_EQ_CACHE)
    tcu_k.copy_(torch.from_numpy(other))
    want = pk.flash_attention_varlen_available(*_jax(q, k, v, cu_q, other),
                                               True)
    assert want is False
    assert ck.flash_attention_varlen_available(tq, tk, tv, tcu_q, tcu_k,
                                               True) == want
    got, _ = F.flash_attn_unpadded(tq, tk, tv, tcu_q, tcu_k, 260, 260,
                                   causal=True)
    dense = _unpadded_impl(tq, tk, tv, tcu_q, tcu_k, 0.125, True, 260, 260)
    torch.testing.assert_close(got, dense, atol=FWD_TOL, rtol=0)
    jgot, _ = JF.flash_attn_unpadded(
        *(paddle.to_tensor(x) for x in (q, k, v, cu_q, other)), 260, 260,
        causal=True)
    np.testing.assert_allclose(got.numpy(), jgot.numpy(), **JAX_FWD)
    # a write through a view bumps the shared version: equal again
    tcu_k[1:3].copy_(tcu_q[1:3])
    assert ck.flash_attention_varlen_available(tq, tk, tv, tcu_q, tcu_k,
                                               True)


def test_gate_compares_inference_tensors_every_time():
    with torch.inference_mode():
        cu_q = torch.tensor([0, 100, 256], dtype=torch.int32)
        cu_k = cu_q.clone()
        q = torch.zeros(256, 2, 64)
        assert ck.flash_attention_varlen_available(q, q, q, cu_q, cu_k,
                                                   True)
        cu_k.copy_(torch.tensor([0, 128, 256], dtype=torch.int32))
        assert not ck.flash_attention_varlen_available(q, q, q, cu_q, cu_k,
                                                       True)
    assert not any(e[0]() is cu_q for e in ck._CU_EQ_CACHE)


def test_autograd_function_runs_the_plain_backward_on_cpu(monkeypatch):
    q, k, v, cu, _ = varlen_inputs(LENGTHS["pads"])
    tq, tk, tv = (x.requires_grad_(True) for x in _torch(q, k, v))
    tcu, tdo = _torch(cu, _do(q.shape))
    calls = _route(monkeypatch, ck, "flash_attention_varlen_bwd")
    o = ck.flash_attention_varlen_values(tq, tk, tv, tcu, tcu, 0.125,
                                         causal=True)
    got = torch.autograd.grad(o, (tq, tk, tv), tdo)
    assert calls == [1]
    with torch.no_grad():
        ro, lse = ck.flash_attention_varlen_reference(tq, tk, tv, tcu, tcu,
                                                      True)
        want = ck.flash_attention_varlen_bwd_reference(tq, tk, tv, ro, lse,
                                                       tdo, tcu, tcu, True)
    assert torch.equal(o.detach(), ro)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


PLAN_CASES = [([100, 260, 150], None, True), ([100, 260, 150], None, False),
              ([1, 977, 2400, 850], None, True), ([512] * 3, None, True),
              ([1, 97, 240, 85], [128] * 4, False),
              ([40, 90, 33], [50, 0, 77], False),
              ([64, 64, 1], [30, 0, 99], False), ([64, 64, 1], None, True)]


@pytest.mark.parametrize("block", [64, 32])
@pytest.mark.parametrize("lq,lk,causal", PLAN_CASES)
def test_plan_ranges_cover_every_visible_pair(lq, lk, causal, block):
    lk = lq if lk is None else lk
    _, _, _, cu_q, cu_k = varlen_inputs(lq, lk, h=1, d=64)
    tq, tk = sum(lq), sum(lk)
    tcu_q, tcu_k = _torch(cu_q, cu_k)
    plan = ck.varlen_plan(tcu_q, tcu_k, tq, tk, causal, block)
    assert all(t.dtype == torch.int32 for t in plan[:6])
    seg_q = np.searchsorted(cu_q, np.arange(tq), side="right")
    seg_k = np.searchsorted(cu_k, np.arange(tk), side="right")
    assert np.array_equal(plan.seg_q.numpy(), seg_q)
    assert np.array_equal(plan.seg_k.numpy(), seg_k)
    seen = seg_q[:, None] == seg_k[None, :]
    if causal:
        seen &= np.arange(tq)[:, None] >= np.arange(tk)[None, :]
    rows, cols = np.nonzero(seen)
    qt, kt = rows // block, cols // block
    kv_lo, kv_hi = plan.kv_lo.numpy(), plan.kv_hi.numpy()
    q_lo, q_hi = plan.q_lo.numpy(), plan.q_hi.numpy()
    assert len(kv_lo) == -(-tq // block) and len(q_lo) == -(-tk // block)
    assert np.all((kv_lo[qt] <= kt) & (kt < kv_hi[qt]))
    assert np.all((q_lo[kt] <= qt) & (qt < q_hi[kt]))
    # the ranges hold no tile without a visible pair at either end
    for lo, hi, owner in ((kv_lo, kv_hi, "q"), (q_lo, q_hi, "kv")):
        for i, (a, b) in enumerate(zip(lo, hi)):
            if b > a:
                pair_tiles = kt[qt == i] if owner == "q" else qt[kt == i]
                assert pair_tiles.min() == a and pair_tiles.max() == b - 1


def test_varlen_entry_point_and_flash_attention_wrapper():
    from paddle_tpu_torch import nn
    assert nn.functional.flash_attn_unpadded is F.flash_attn_unpadded
    q, k, v = (np.random.default_rng(i).standard_normal((1, 128, 2, 64))
               .astype(np.float32) for i in range(3))
    want, _ = JF.flash_attention(*(paddle.to_tensor(x) for x in (q, k, v)),
                                 causal=True)
    got, none = F.flash_attention(*_torch(q, k, v), causal=True)
    assert none is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), **JAX_FWD)


@pytest.mark.parametrize(
    "route,d", [pytest.param("fp32", d, id=str(d)) for d in (64, 128, 256)]
    + [pytest.param("bf16", d, id=f"bf16-{d}") for d in (64, 128, 256)])
def test_varlen_shared_memory_fits_a_block(route, d):
    # the kernels' notes state each pass's bytes per d and route. fp32: K4
    # q/k tiles [64, d + 1], v [64, d], probs [64, 65] and 128 int32
    # segment ids; K5 as K3 (64-row tiles, 32 at d = 256) plus 2 r int32
    # segment ids. bf16: K4 the 64-row q tile and two stages of [n, d] k
    # and v tiles and n seg_k ids (n = 32 at d = 256, else 64); K5 dk/dv
    # the 64-row k and v tiles and two stages of [m, d] q and do tiles and
    # of m lse, delta and seg_q words (m = 64 at d = 64, else 32); dq the
    # 64-row q and do tiles and two stages of [n, d] k and v tiles and n
    # seg_k ids. The bf16 route's plan tile is 64 at every d.
    if route == "fp32":
        fwd = 4 * (2 * 64 * (d + 1) + 64 * d + 64 * 65) + 4 * 128
        r = 32 if d == 256 else 64
        dkdv = 4 * (4 * r * (d + 1) + 2 * r * (r + 1) + 2 * r) + 4 * 2 * r
        dq = 4 * (4 * r * (d + 1) + r * (r + 1)) + 4 * 2 * r
        dtype = torch.float32
    else:
        m, n = (64 if d == 64 else 32), (32 if d == 256 else 64)
        fwd = 2 * (64 * d + 4 * n * d) + 4 * 2 * n
        dkdv = 2 * (2 * 64 * d + 4 * m * d) + 4 * 4 * m + 4 * 2 * m
        dq = 2 * (2 * 64 * d + 4 * n * d) + 4 * 2 * n
        r, dtype = 64, torch.bfloat16
    assert max(fwd, dkdv, dq) <= 232448
    assert ck._vl_bwd_block(d, dtype) == r
    csrc = Path(ck.__file__).parents[1] / "csrc"
    assert f"{fwd:,}" in (csrc / "flash_varlen_fwd.cu").read_text()
    bwd = (csrc / "flash_varlen_bwd.cu").read_text()
    assert f"{dkdv:,}" in bwd and f"{dq:,}" in bwd
