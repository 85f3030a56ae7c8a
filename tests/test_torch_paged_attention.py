"""K1, paged attention (``paddle_tpu_torch/ops/cuda_kernels.py``): the
port's plain version against the JAX package's Pallas kernel (interpret
mode) and its dense reference, on the same seeded numpy inputs.

Cases follow ``tests/test_serving.py`` TestPagedKernel and
TestPagedVerifyKernel: ragged contexts, a sequence exactly filling a
page, an append crossing a page, empty tables, KQ in {1, 3, 5}, bf16
pools. Tolerances: fp32 at K*eps with K the longest context (f32
accumulation over K terms); bf16 at 48 * 2**-8 (bf16 storage).

``tests/test_torch_cuda_kernels.py`` holds the CUDA kernel against the
same plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import F32_EPS, paged_inputs
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

BF16_TOL = 48 * 2 ** -8


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "1")


def _both(arrs, dtype="float32"):
    """(jax arrays, torch CPU tensors) of the same numpy inputs."""
    q, kp, vp, bt, cl = arrs
    tdt = getattr(torch, dtype)
    j = (jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
         jnp.asarray(vp, dtype), jnp.asarray(bt), jnp.asarray(cl))
    t = (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
         torch.from_numpy(vp).to(tdt), torch.from_numpy(bt),
         torch.from_numpy(cl))
    return j, t


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# each case runs against the JAX reference; the interpret-mode JAX kernel
# (seconds per call on this CPU) joins on the cases marked True
@pytest.mark.parametrize("ctxs,vs_kernel",
                         [([5, 16, 17, 40, 64], True), ([16], False),
                          ([17], False), ([0, 9], True)],
                         ids=["ragged", "full_page", "append_crosses_page",
                              "empty_table"])
def test_decode_matches_jax_kernel_and_reference(ctxs, vs_kernel,
                                                 interpret):
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, tbt, tcl) = _both(
        paged_inputs(ctxs, 1))
    got = ck.paged_attention_decode(tq[:, 0], tk, tv, tbt, tcl)
    ref = pk.paged_attention_reference(jq[:, 0], jk, jv, jbt, jcl)
    tol = max(max(ctxs), 1) * F32_EPS
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    if vs_kernel:
        kern = pk.paged_attention_decode(jq[:, 0], jk, jv, jbt, jcl)
        np.testing.assert_allclose(_np(got), _np(kern), rtol=tol, atol=tol)
    assert torch.equal(got, ck.paged_attention_reference(
        tq[:, 0], tk, tv, tbt, tcl))


@pytest.mark.parametrize("ctxs,kq,vs_kernel",
                         [([5, 16, 17, 40, 64], 5, True),
                          ([5, 16, 17, 40, 64], 3, False),
                          ([63, 127], 4, True), ([100], 3, False),
                          ([0, 20], 3, False)],
                         ids=["ragged_k5", "ragged_k3", "rows_cross_pages",
                              "seven_pages", "inactive_slot"])
def test_verify_matches_jax_kernel_and_reference(ctxs, kq, vs_kernel,
                                                 interpret):
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, tbt, tcl) = _both(
        paged_inputs(ctxs, kq))
    got = ck.paged_attention_verify_decode(tq, tk, tv, tbt, tcl)
    ref = pk.paged_attention_verify_reference(jq, jk, jv, jbt, jcl)
    tol = (max(ctxs) + kq) * F32_EPS
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    if vs_kernel:
        kern = pk.paged_attention_verify_decode(jq, jk, jv, jbt, jcl)
        np.testing.assert_allclose(_np(got), _np(kern), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inactive_rows_are_exact_positive_zeros(dtype):
    _, (tq, tk, tv, tbt, tcl) = _both(paged_inputs([0, 20, 0], 3), dtype)
    got = ck.paged_attention_verify_decode(tq, tk, tv, tbt, tcl).float()
    for slot in (0, 2):
        assert torch.all(got[slot] == 0)
        assert not torch.signbit(got[slot]).any()
    # a fully inactive batch: every row exactly +0, no NaN
    _, (tq, tk, tv, tbt, tcl) = _both(paged_inputs([0, 0], 1), dtype)
    got = ck.paged_attention_decode(tq[:, 0], tk, tv, tbt, tcl).float()
    assert torch.all(got == 0) and not torch.signbit(got).any()


@pytest.mark.parametrize("kq,vs_kernel", [(1, False), (3, True)])
def test_bf16_pools_match_jax(kq, vs_kernel, interpret):
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, tbt, tcl) = _both(
        paged_inputs([23, 48], kq), "bfloat16")
    got = ck.paged_attention_verify_decode(tq, tk, tv, tbt, tcl)
    assert got.dtype == torch.bfloat16
    ref = pk.paged_attention_verify_reference(jq, jk, jv, jbt, jcl)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=BF16_TOL,
                               atol=BF16_TOL)
    if vs_kernel:
        kern = pk.paged_attention_verify_decode(jq, jk, jv, jbt, jcl)
        np.testing.assert_allclose(_np(got), _np(kern), rtol=BF16_TOL,
                                   atol=BF16_TOL)


def test_routes_take_the_wrapper_when_the_gate_admits():
    _, (tq, tk, tv, tbt, tcl) = _both(paged_inputs([9, 33], 2))
    assert torch.equal(ck.paged_attention_verify(tq, tk, tv, tbt, tcl),
                       ck.paged_attention_verify_decode(tq, tk, tv, tbt,
                                                        tcl))
    assert torch.equal(ck.paged_attention(tq[:, 0], tk, tv, tbt, tcl),
                       ck.paged_attention_decode(tq[:, 0], tk, tv, tbt,
                                                 tcl))
    # d = 32 is refused by the gate: the route runs the dense version
    q32 = tq[:, 0, :, :32].contiguous()
    k32 = tk.reshape(tk.shape[0], tk.shape[1], 2, 64)[..., :32] \
        .reshape(tk.shape[0], tk.shape[1], 64).contiguous()
    out = ck.paged_attention(q32, k32, k32, tbt, tcl)
    assert torch.equal(out, ck.paged_attention_reference(q32, k32, k32,
                                                         tbt, tcl))


def test_gate_matches_the_jax_contract(interpret):
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, tbt, tcl) = _both(
        paged_inputs([16], 1))
    cases = [
        ((tq[:, 0], tk, tv, tbt, tcl), (jq[:, 0], jk, jv, jbt, jcl)),
        ((tq[:, 0, :, :32], tk, tv, tbt, tcl),          # d not admitted
         (jq[:, 0, :, :32], jk, jv, jbt, jcl)),
        ((tq[:, 0], tk[:, :9], tv[:, :9], tbt, tcl),    # page % 16 != 0
         (jq[:, 0], jk[:, :9], jv[:, :9], jbt, jcl)),
        ((tq[:, 0], tk, tv, tbt[0], tcl),               # table not 2-D
         (jq[:, 0], jk, jv, jbt[0], jcl)),
        ((tq[:, 0], tk, tv, tbt, torch.zeros(3, dtype=torch.int32)),
         (jq[:, 0], jk, jv, jbt, jnp.zeros((3,), jnp.int32))),
        ((tq[:, 0], tk, tv[:-1], tbt, tcl),             # pools disagree
         (jq[:, 0], jk, jv[:-1], jbt, jcl)),
    ]
    got = [ck.paged_attention_available(*t) for t, _ in cases]
    want = [pk.paged_attention_available(*j) for _, j in cases]
    assert got == want == [True] + [False] * 5
    assert ck.paged_attention_verify_available(tq, tk, tv, tbt, tcl)
    assert not ck.paged_attention_verify_available(tq[:, :0], tk, tv, tbt,
                                                   tcl)
