"""K1, paged attention (``paddle_tpu_torch/ops/cuda_kernels.py``): the
port's plain version against the JAX package's Pallas kernel (interpret
mode) and its dense reference, on the same seeded numpy inputs.

Cases follow ``tests/test_serving.py`` TestPagedKernel and
TestPagedVerifyKernel: ragged contexts, a sequence exactly filling a
page, an append crossing a page, empty tables, KQ in {1, 3, 5}, bf16
pools. Tolerances: fp32 at K*eps with K the longest context (f32
accumulation over K terms); bf16 at 48 * 2**-8 (bf16 storage), fp16 at
48 * 2**-11 (the same bound in fp16's units).

The plain split-and-combine version (``paged_attention_split_reference``,
the arithmetic of the bf16 CUDA route: per-split (m, l, acc) in fp32,
merged in split order) is held to the same references on the same cases
and at the edges of a 256-token split: contexts one below, at and one
above a split's length, KQ = 5 rows whose last token crosses a split,
tables holding pages past their slots' contexts, all-inactive batches.

``tests/test_torch_cuda_kernels.py`` holds the CUDA kernel against the
same plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import F32_EPS, paged_inputs, paged_tols
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

BF16_TOL = 48 * 2 ** -8
FP16_TOL = 48 * 2 ** -11   # the bf16 bound in fp16's units


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


@pytest.mark.parametrize("kq,vs_kernel", [(1, False), (3, True)])
def test_fp16_pools_match_jax(kq, vs_kernel, interpret):
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, tbt, tcl) = _both(
        paged_inputs([23, 48], kq), "float16")
    got = ck.paged_attention_verify_decode(tq, tk, tv, tbt, tcl)
    assert got.dtype == torch.float16
    ref = pk.paged_attention_verify_reference(jq, jk, jv, jbt, jcl)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=FP16_TOL,
                               atol=FP16_TOL)
    if vs_kernel:
        kern = pk.paged_attention_verify_decode(jq, jk, jv, jbt, jcl)
        np.testing.assert_allclose(_np(got), _np(kern), rtol=FP16_TOL,
                                   atol=FP16_TOL)


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


# (contexts, KQ, spare pages per table, also against the JAX kernel)
SPLIT_CASES = {
    "ragged": ([5, 16, 17, 40, 64], 1, 0, False),
    "ragged_k5": ([5, 16, 17, 40, 64], 5, 0, False),
    "rows_cross_pages": ([63, 127], 4, 0, False),
    "inactive_slot": ([0, 20], 3, 0, False),
    "split_edges": ([255, 256, 257], 1, 0, True),
    "split_edges_513": ([511, 512, 513], 1, 0, False),
    "verify_crosses_split": ([252, 253, 254, 0], 5, 0, True),
    "table_past_context": ([100, 0, 17], 1, 20, True),
    "table_past_context_k5": ([100, 256, 0], 5, 20, False),
    "all_inactive": ([0, 0, 0], 1, 0, False),
    "all_inactive_k5": ([0, 0], 5, 0, False),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_version_matches_jax_kernel_and_reference(case, interpret):
    ctxs, kq, spare, vs_kernel = SPLIT_CASES[case]
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, tbt, tcl) = _both(
        paged_inputs(ctxs, kq, spare=spare))
    got = ck.paged_attention_split_reference(tq, tk, tv, tbt, tcl)
    ref = pk.paged_attention_verify_reference(jq, jk, jv, jbt, jcl)
    tol = (max(ctxs) + kq) * F32_EPS
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(ck.paged_attention_verify_reference(tq, tk, tv, tbt, tcl)),
        _np(ref), rtol=tol, atol=tol)
    if vs_kernel:
        kern = pk.paged_attention_verify_decode(jq, jk, jv, jbt, jcl)
        np.testing.assert_allclose(_np(got), _np(kern), rtol=tol, atol=tol)
    for slot, c in enumerate(ctxs):
        if c == 0:
            assert torch.all(got[slot] == 0)
            assert not torch.signbit(got[slot]).any()


@pytest.mark.parametrize("case", ["split_edges", "verify_crosses_split"])
def test_split_version_bf16_matches_jax(case, interpret):
    ctxs, kq, spare, _ = SPLIT_CASES[case]
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, tbt, tcl) = _both(
        paged_inputs(ctxs, kq, spare=spare), "bfloat16")
    got = ck.paged_attention_split_reference(tq, tk, tv, tbt, tcl)
    assert got.dtype == torch.bfloat16
    ref = pk.paged_attention_verify_reference(jq, jk, jv, jbt, jcl)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("case", ["split_edges", "verify_crosses_split"])
def test_split_version_fp16_matches_jax(case, interpret):
    ctxs, kq, spare, _ = SPLIT_CASES[case]
    (jq, jk, jv, jbt, jcl), (tq, tk, tv, tbt, tcl) = _both(
        paged_inputs(ctxs, kq, spare=spare), "float16")
    got = ck.paged_attention_split_reference(tq, tk, tv, tbt, tcl)
    assert got.dtype == torch.float16
    ref = pk.paged_attention_verify_reference(jq, jk, jv, jbt, jcl)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=FP16_TOL,
                               atol=FP16_TOL)


def test_splits_follow_the_tables_extent():
    # serving's table: 1024 tokens in pages of 16 -> 4 splits of 16 pages
    assert ck.paged_splits(64, 16) == (16, 4)
    assert ck.paged_splits(65, 16) == (16, 5)
    assert ck.paged_splits(3, 32) == (8, 1)
    assert ck.paged_splits(0, 16) == (16, 1)
    # a split never exceeds the 16 pages the CUDA kernel stages
    assert all(ck.paged_splits(100, p)[0] <= 16 for p in (16, 32, 64, 512))


def test_the_split_version_takes_strided_q():
    # the serving engine's q: a column slice of the packed qkv
    _, (tq, tk, tv, tbt, tcl) = _both(paged_inputs([40, 300], 3))
    qkv = torch.cat([tq, torch.zeros_like(tq), torch.ones_like(tq)], -1)
    q = qkv[..., :tq.shape[-1]]
    assert not q.is_contiguous()
    assert torch.equal(
        ck.paged_attention_split_reference(q, tk, tv, tbt, tcl),
        ck.paged_attention_split_reference(tq, tk, tv, tbt, tcl))


def test_paged_shared_memory_fits_a_block():
    # the fp32 route's scalar tiles grow with KQ and are checked before the
    # launch; the bf16 route's ring does not grow with KQ, and its source
    # checks it at compile time
    assert ck._paged_smem(5, 64) == 4 * (2 * 5 * 64 + 2 * 32 * 64
                                         + 5 * 32 + 3 * 5)
    assert all(ck._paged_smem(kq, d) <= ck._MAX_SMEM
               for d in (64, 128, 256) for kq in (1, 5, 9))


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_version_bf16_within_rounding_of_fp32(case):
    # the bound the card holds the bf16 kernel to
    ctxs, kq, spare, _ = SPLIT_CASES[case]
    _, (tq, tk, tv, tbt, tcl) = _both(paged_inputs(ctxs, kq, spare=spare),
                                      "bfloat16")
    got = ck.paged_attention_split_reference(tq, tk, tv, tbt, tcl)
    ref = ck.paged_attention_verify_reference(tq.float(), tk.float(),
                                              tv.float(), tbt, tcl)
    atol, rtol = paged_tols(got.dtype, max(ctxs), kq, tv)
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_version_fp16_within_rounding_of_fp32(case):
    # the bound the card holds the fp16 kernel to (rtol 2**-11)
    ctxs, kq, spare, _ = SPLIT_CASES[case]
    _, (tq, tk, tv, tbt, tcl) = _both(paged_inputs(ctxs, kq, spare=spare),
                                      "float16")
    got = ck.paged_attention_split_reference(tq, tk, tv, tbt, tcl)
    ref = ck.paged_attention_verify_reference(tq.float(), tk.float(),
                                              tv.float(), tbt, tcl)
    atol, rtol = paged_tols(got.dtype, max(ctxs), kq, tv)
    assert rtol == 2 ** -11
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)


def test_paged_q_is_read_in_place_where_its_layout_allows():
    _, (tq, *_) = _both(paged_inputs([9, 40, 3], 2), "bfloat16")
    b, kq, h, d = tq.shape
    qkv = torch.zeros(b, kq, 3 * h * d, dtype=tq.dtype)
    sliced = qkv[..., :h * d].view(b, kq, h, d)     # the engine's q
    q, sb, sj = ck._paged_q(sliced, True)
    assert q is sliced and (sb, sj) == (3 * h * d * kq, 3 * h * d)
    odd = torch.zeros(b, kq, h * d + 1, dtype=tq.dtype)[..., :h * d] \
        .view(b, kq, h, d)
    assert ck._paged_q(odd, False)[0] is odd        # fp32: any row stride
    for other in (odd, tq.transpose(2, 3).contiguous().transpose(2, 3)):
        q, sb, sj = ck._paged_q(other, True)
        assert q.is_contiguous() and torch.equal(q, other)
        assert (sb, sj) == (kq * h * d, h * d)
    one = tq[:1, :1]                                 # B = KQ = 1
    assert ck._paged_q(one, True)[1:] == (0, 0)
