"""The port's hand-written CUDA kernels on the card: each kernel held
against its plain PyTorch version, the wrappers' refusals, and the
serving engine's and the train step's launches. Every test is marked
``cuda`` and skips where no card is present.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: K1 fp32 at K*eps with K the longest context; bf16 against
its plain version in fp32 on the same widened inputs, element by element
at atol K*eps*max|v| (fp32 sums) and rtol 2**-8 (half a bf16 ulp: the
output is rounded once); K2 fp32 at atol 2e-5; K3 fp32 at atol 5e-5
(2e-4 where kv heads are shared), the JAX package's flash-backward
bounds. K2 and K3 in bf16 run the tensor-core route, which rounds p (and
in K3 ds) to bf16 before the products that take them, as the JAX kernels
do, and rounds each output once: each is held at one ulp of its outputs'
largest magnitude (``chip_smoke.py`` also holds these bounds to twice
the error of ``scaled_dot_product_attention`` against the same plain
version). K4 fp32 at 2e-5 and bf16 at 2**-6 (two ulps of an output below
2: the bf16 route, on tensor cores like K2's, rounds p to bf16 before
P v and o once); K5 as K3 (fp32 at 5e-5: no shared kv heads; bf16 one ulp
at the outputs' largest magnitude). fp16 runs the same 16-bit routes and
is held to the same bounds in fp16's ulps (11 significant bits: K1 at
rtol 2**-11, K4 at 2**-9). K3, K4 and K5 runs repeat with the
same bits, K4 and K5 also at the packed-attention workload's shape.
Misaligned bf16 operands are refused, except K1's q, which is copied.
TF32 is off for every fp32 comparison (the ``cuda_device`` fixture sets
it).
"""
import numpy as np
import pytest
import torch

from _torch_helpers import (cuda_device, flash_inputs,  # noqa: F401
                            paged_inputs, paged_tols, varlen_inputs)
from paddle_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda

FLASH_CASES = {   # b, sq, sk, h, kh, d, causal
    "causal": (1, 128, 128, 2, 2, 64, True),
    "noncausal": (2, 128, 256, 2, 2, 64, False),
    "gqa": (1, 256, 256, 4, 2, 64, True),
    "mqa": (1, 128, 128, 4, 1, 64, True),
    "nonsquare_causal": (1, 128, 384, 2, 2, 64, True),
    "d128": (1, 256, 256, 2, 2, 128, True),
    "d256": (1, 128, 128, 2, 2, 256, True),
    # offset 128 (the smallest nonzero one the gate admits) where the
    # tensor-core K3's dk/dv pass steps 32 q rows over its kv tile, and
    # where the dq pass steps 32-row kv tiles (d = 256)
    "nonsquare_d128": (1, 256, 384, 2, 2, 128, True),
    "nonsquare_d256": (1, 128, 256, 2, 2, 256, True),
    # the encoder paths' attention, non-causal: ERNIE-3.0-base
    # pretraining at 16 x 512, BERT-base finetuning at 32 x 128
    "ernie_noncausal": (16, 512, 512, 12, 12, 64, False),
    "bert_noncausal": (32, 128, 128, 12, 12, 64, False),
    # the hybrid-parallel path's: a TP GPT-124M rank's 6 heads at the
    # global 8 x 1024, a ZeRO-3 ERNIE rank's 8 x 512
    "tp_gpt124m_rank": (8, 1024, 1024, 6, 6, 64, True),
    "zero3_ernie_rank": (8, 512, 512, 12, 12, 64, False),
    # the context-parallel path's (GPT-124M at 2 x 8192 over sep 2, each
    # rank [2, 4096]): the zigzag ring's own pair, its earlier-owner block
    # (head-half kv) and later-owner block (tail-half q), and Ulysses'
    # whole sequence on 12 / 2 heads
    "cp_own_chunk": (2, 4096, 4096, 12, 12, 64, True),
    "cp_earlier_owner": (2, 4096, 2048, 12, 12, 64, False),
    "cp_later_owner": (2, 2048, 4096, 12, 12, 64, False),
    "cp_ulysses": (2, 8192, 8192, 6, 6, 64, True),
    # the pipeline path's microbatch: GPT-124M's 16 x 1024 in 8 pieces
    "pp_microbatch": (2, 1024, 1024, 12, 12, 64, True),
    # the grad_comm path's GradientMerge microbatch: GPT-124M at k 4 over
    # [4, 1024]
    "gm_microbatch": (4, 1024, 1024, 12, 12, 64, True),
}
# the training path's attention, GPT-124M at batch 16
TRAIN_CASE = (16, 1024, 1024, 12, 12, 64, True)


def _ulp(x, dtype):
    """The spacing of ``dtype`` values at magnitude x: 8 significant bits
    for bf16, 11 for fp16."""
    return 2.0 ** (np.floor(np.log2(x)) - (10 if dtype == "float16" else 7))


def _assert_paged_close(got, q, kp, vp, bt, cl):
    """K1's output against its plain version in fp32 on the same inputs,
    at ``paged_tols``."""
    ref = ck.paged_attention_verify_reference(q.float(), kp.float(),
                                              vp.float(), bt, cl)
    atol, rtol = paged_tols(got.dtype, int(cl.max()), q.shape[1], vp)
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)


def _paged(ctxs, kq, dtype, device, spare=0):
    q, kp, vp, bt, cl = paged_inputs(ctxs, kq, spare=spare)
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(q).to(device, tdt),
            torch.from_numpy(kp).to(device, tdt),
            torch.from_numpy(vp).to(device, tdt),
            torch.from_numpy(bt).to(device), torch.from_numpy(cl).to(device))


# the last six sit at the edges of the bf16 route's 256-token splits and
# row groups: contexts one below, at and one above a split's length (and
# two), KQ = 5 rows whose last token crosses a split, tables holding pages
# past their slots' contexts, eight verify rows (a full row group) and
# nine (two groups)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("ctxs,kq,spare",
                         [([5, 16, 17, 40, 64], 1, 0),
                          ([0, 20, 63, 127], 5, 0),
                          ([100], 3, 0), ([0, 0], 1, 0),
                          ([255, 256, 257, 511, 512, 513], 1, 0),
                          ([252, 253, 254, 256, 0], 5, 0),
                          ([100, 0, 17, 256], 1, 20),
                          ([100, 0, 17, 256], 5, 20),
                          ([1, 250, 600], 8, 0), ([40, 300], 9, 0)],
                         ids=["ragged", "verify_k5", "seven_pages",
                              "inactive_batch", "split_edges",
                              "verify_crosses_split", "table_past_context",
                              "table_past_context_k5", "verify_k8",
                              "verify_k9_two_row_groups"])
def test_paged_kernel_matches_plain_version(cuda_device, ctxs, kq, spare,
                                            dtype):
    q, kp, vp, bt, cl = _paged(ctxs, kq, dtype, cuda_device, spare)
    before = ck.PAGED_ATTENTION.launches
    got = ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert ck.PAGED_ATTENTION.launches == before + 1
    _assert_paged_close(got, q, kp, vp, bt, cl)
    for i, c in enumerate(ctxs):
        if c == 0:
            assert torch.all(got[i] == 0)
            assert not torch.signbit(got[i].float()).any()


def test_paged_decode_is_the_kq1_case(cuda_device):
    q, kp, vp, bt, cl = _paged([9, 33], 1, "float32", cuda_device)
    via_verify = ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
    via_decode = ck.paged_attention_decode(q[:, 0], kp, vp, bt, cl)
    assert torch.equal(via_verify[:, 0], via_decode)


def test_paged_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q, kp, vp, bt, cl = _paged([9], 1, "float32", cuda_device)
    with pytest.raises(TypeError):
        ck.paged_attention_verify_decode(q, kp, vp, bt.long(), cl)
    # float16 has a route since the fp16 repair; float64 has none
    with pytest.raises(TypeError):
        ck.paged_attention_verify_decode(q.double(), kp.double(),
                                         vp.double(), bt, cl)
    with pytest.raises(ValueError):
        ck.paged_attention_verify_decode(q.cpu(), kp, vp, bt, cl)
    # the bf16 route loads the pools 16 bytes at a time, in place
    q, kp, vp, bt, cl = _paged([9, 40], 2, "bfloat16", cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        ck.paged_attention_verify_decode(q, _misaligned(kp), vp, bt, cl)
    with pytest.raises(ValueError, match="16-byte"):
        ck.paged_attention_verify_decode(q, kp, _misaligned(vp), bt, cl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_paged_kernel_reads_q_in_place(cuda_device, dtype):
    # the serving engine's q: a column slice of the packed qkv [B, KQ, 3hd]
    q, kp, vp, bt, cl = _paged([9, 300, 0, 700], 3, dtype, cuda_device)
    b, kq, h, d = q.shape
    qkv = torch.cat([q.reshape(b, kq, h * d), torch.randn_like(
        q.reshape(b, kq, h * d)).repeat(1, 1, 2)], -1)
    strided = qkv[..., :h * d].reshape(b, kq, h, d)
    assert not strided.is_contiguous()
    got = ck.paged_attention_verify_decode(strided, kp, vp, bt, cl)
    assert torch.equal(got, ck.paged_attention_verify_decode(q, kp, vp, bt,
                                                             cl))
    decode = ck.paged_attention_decode(strided[:, 0], kp, vp, bt, cl)
    assert torch.equal(decode, ck.paged_attention_decode(
        q[:, 0].contiguous(), kp, vp, bt, cl))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_paged_kernel_copies_q_it_cannot_read_in_place(cuda_device, dtype):
    # a q whose head stride is not d, one that starts off a 16-byte
    # boundary, and one whose row stride is odd: each is copied, then
    # gives the contiguous q's bits
    q, kp, vp, bt, cl = _paged([9, 300, 0, 700], 3, dtype, cuda_device)
    b, kq, h, d = q.shape
    want = ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
    odd = torch.zeros(b, kq, h * d + 1, dtype=q.dtype, device=q.device)
    odd[..., :h * d] = q.reshape(b, kq, h * d)
    for other in (q.transpose(2, 3).contiguous().transpose(2, 3),
                  _misaligned(q), odd[..., :h * d].view(b, kq, h, d)):
        before = ck.PAGED_ATTENTION.launches
        assert torch.equal(
            ck.paged_attention_verify_decode(other, kp, vp, bt, cl), want)
        assert ck.PAGED_ATTENTION.launches == before + 1


def test_paged_kernel_reruns_bit_identical_at_the_serving_shape(
        cuda_device):
    # chip_smoke.py's serving contexts: B = 8, h = 12, d = 64, page 16
    for kq, ctxs in ((1, [0, 1, 17, 130, 511, 700, 1000, 1024]),
                     (5, [0, 1, 17, 130, 511, 700, 1000, 1020])):
        q, kp, vp, bt, cl = (torch.from_numpy(x).to(cuda_device)
                             for x in paged_inputs(ctxs, kq, h=12))
        q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
        first = ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
        for _ in range(2):
            assert torch.equal(
                first, ck.paged_attention_verify_decode(q, kp, vp, bt, cl))
        _assert_paged_close(first, q, kp, vp, bt, cl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernel_matches_plain_version(cuda_device, case, dtype):
    b, sq, sk, h, kh, d, causal = FLASH_CASES[case]
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda_device, tdt)
               for x in flash_inputs(b, sq, sk, h, kh, d))
    before = ck.FLASH_FWD.launches
    o, lse = ck.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ck.FLASH_FWD.launches == before + 1
    ro, rlse = ck.flash_attention_reference(q, k, v, causal=causal)
    # bf16 and fp16: one ulp at the largest |o|, half from rounding o and
    # the rest for the 16-bit p the kernel feeds to P V (each weight off by
    # at most half an ulp of itself; the errors average out along the row)
    tol = 2e-5 if dtype == "float32" else \
        _ulp(float(ro.float().abs().max()), dtype)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    # a rerun gives the same bits
    o2, lse2 = ck.flash_attention_with_lse(q, k, v, causal=causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _flash_bwd_args(case, dtype, device, dlse):
    b, sq, sk, h, kh, d, causal = TRAIN_CASE if case == "gpt124m_train" \
        else FLASH_CASES[case]
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(device, tdt)
               for x in flash_inputs(b, sq, sk, h, kh, d))
    rng = np.random.default_rng(1)
    do = torch.from_numpy(rng.standard_normal((b, sq, h, d))
                          .astype(np.float32)).to(device, tdt)
    dl = torch.from_numpy(rng.standard_normal((b, h, sq)).astype(
        np.float32)).to(device) if dlse else None
    o, lse = ck.flash_attention_with_lse(q, k, v, causal=causal)
    return (q, k, v, o, lse, do, dl), causal


@pytest.mark.parametrize("dlse", [False, True], ids=["no_dlse", "dlse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_bwd_kernel_matches_plain_version(cuda_device, case, dtype,
                                                dlse):
    args, causal = _flash_bwd_args(case, dtype, cuda_device, dlse)
    before = ck.FLASH_BWD.launches
    got = ck.flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    assert ck.FLASH_BWD.launches == before + 1
    ref = ck.flash_attention_bwd_reference(*args, causal=causal)
    _, _, _, h, kh, _, _ = FLASH_CASES[case]
    if dtype == "float32":
        tol = 2e-4 if kh != h else 5e-5
    else:
        # one ulp at the outputs' largest magnitude, half from rounding
        # dq, dk, dv and the rest for the 16-bit p and ds the kernel feeds
        # to its products (each off by at most half an ulp of itself; the
        # errors average out over the summed rows)
        tol = _ulp(max(float(r.float().abs().max()) for r in ref), dtype)
    for g, r, x in zip(got, ref, args[:3]):
        assert g.shape == x.shape and g.dtype == x.dtype
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("case,dtype", [("gqa", "float32"),
                                        ("gpt124m_train", "bfloat16"),
                                        ("gpt124m_train", "float16"),
                                        ("ernie_noncausal", "bfloat16"),
                                        ("bert_noncausal", "bfloat16")])
def test_flash_bwd_kernel_is_deterministic(cuda_device, case, dtype):
    args, causal = _flash_bwd_args(case, dtype, cuda_device, True)
    first = ck.flash_attention_bwd(*args, causal=causal)
    for _ in range(2):
        again = ck.flash_attention_bwd(*args, causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_fp16_overflow_becomes_inf_as_in_the_plain_version(cuda_device):
    # q = k = 0 makes row i's weights exactly 1 / (i + 1) over its causal
    # columns, so with do = 30000 column j of dv is 30000 (H(128) - H(j)):
    # past fp16's range for j <= 13 (67,590 at j = 13), inside it from
    # j = 14 (65,445). The kernel rounds dv to fp16 without a clamp, so
    # those entries are inf, as the plain version's cast makes them: a
    # loss scaler has to see the overflow
    b, s_, h, d = 1, 128, 2, 64
    q = torch.zeros(b, s_, h, d, device=cuda_device, dtype=torch.float16)
    k = torch.zeros_like(q)
    v = torch.randn(b, s_, h, d, device=cuda_device).to(torch.float16)
    do = torch.full_like(q, 30000.0)
    o, lse = ck.flash_attention_with_lse(q, k, v, causal=True)
    got = ck.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    ref = ck.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    dv, ref_dv = got[2], ref[2]
    assert torch.equal(torch.isinf(dv), torch.isinf(ref_dv))
    assert torch.isinf(dv[0, :14]).all() and torch.isfinite(dv[0, 14:]).all()
    assert (dv[0, :14] > 0).all()


def test_gradient_flows_through_both_kernels(cuda_device):
    args, causal = _flash_bwd_args("nonsquare_causal", "float32",
                                   cuda_device, True)
    q, k, v = (t.clone().requires_grad_(True) for t in args[:3])
    do, dl = args[5], args[6]
    fwd, bwd = ck.FLASH_FWD.launches, ck.FLASH_BWD.launches
    o, lse = ck.flash_attention_with_lse(q, k, v, causal=causal)
    grads = torch.autograd.grad((o * do).sum() + (lse * dl).sum(),
                                (q, k, v))
    torch.cuda.synchronize()
    assert ck.FLASH_FWD.launches == fwd + 1
    assert ck.FLASH_BWD.launches == bwd + 1
    want = ck.flash_attention_bwd_reference(q.detach(), k.detach(),
                                            v.detach(), o.detach(),
                                            lse.detach(), do, dl,
                                            causal=causal)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=5e-5, rtol=0)


def test_flash_bwd_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    args, causal = _flash_bwd_args("causal", "float32", cuda_device, False)
    q, k, v, o, lse, do, _ = args
    with pytest.raises(TypeError):
        ck.flash_attention_bwd(q, k, v, o, lse, do.half(), causal=causal)
    with pytest.raises(ValueError):
        ck.flash_attention_bwd(q, k, v, o, lse.double(), do, causal=causal)
    with pytest.raises(ValueError):
        ck.flash_attention_bwd(q, k, v, o, lse, do.cpu(), causal=causal)


def test_train_step_runs_every_layer_through_both_kernels(cuda_device):
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(vocab_size=128, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=256)
    model = GPTForPretraining(cfg, device=cuda_device, seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = CompiledTrainStep(lambda i, lb: model(i, labels=lb)[1], model,
                             opt, amp_level="O2")
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(0, 128, (2, 256)))
                   .to(cuda_device) for _ in range(2))
    fwd, bwd = ck.FLASH_FWD.launches, ck.FLASH_BWD.launches
    losses = [float(step(ids, labels)) for _ in range(3)]
    assert ck.FLASH_FWD.launches - fwd == 3 * cfg.num_layers
    assert ck.FLASH_BWD.launches - bwd == 3 * cfg.num_layers
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("family", ["ernie", "bert"])
def test_encoder_o2_step_runs_every_layer_through_both_kernels(cuda_device,
                                                               family):
    """One O2 step of ERNIE-3.0-base pretraining or BERT-base finetuning
    (12 layers at full width, batch 2 x 512 and 2 x 128): K2 and K3,
    non-causal, once per layer."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text import bert, ernie
    rng = np.random.default_rng(0)
    if family == "ernie":
        cfg = ernie.ernie_3_0_base(hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0,
                                   max_position_embeddings=512)
        model = ernie.ErnieForPretraining(cfg, device=cuda_device, seed=0)
        ids = rng.integers(0, cfg.vocab_size, (2, 512))
        labels = rng.integers(0, cfg.vocab_size, (2, 512))
    else:
        cfg = bert.bert_base(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
        model = bert.BertForSequenceClassification(cfg, device=cuda_device,
                                                   seed=0)
        ids = rng.integers(0, cfg.vocab_size, (2, 128))
        labels = rng.integers(0, 2, (2,))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = CompiledTrainStep(lambda i, lb: model(i, labels=lb)[1], model,
                             opt, amp_level="O2")
    fwd, bwd = ck.FLASH_FWD.launches, ck.FLASH_BWD.launches
    loss = float(step(torch.from_numpy(ids).to(cuda_device),
                      torch.from_numpy(labels).to(cuda_device)))
    assert ck.FLASH_FWD.launches - fwd == 12
    assert ck.FLASH_BWD.launches - bwd == 12
    assert np.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_engine_runs_every_layer_through_the_paged_kernel(cuda_device):
    from paddle_tpu_torch.inference.serving import (Request, ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(vocab_size=128, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=256)
    model = GPTForPretraining(cfg, device=cuda_device, seed=0).eval()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128, n).tolist() for n in (5, 16, 40)]
    for spec_k in (0, 3):
        eng = ServingEngine(model, ServingConfig(page_size=16, max_batch=4,
                                                 spec_k=spec_k),
                            device=cuda_device)
        reqs = [Request(p, max_new_tokens=8) for p in prompts]
        before = ck.PAGED_ATTENTION.launches
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert ck.PAGED_ATTENTION.launches - before == \
            cfg.num_layers * eng.decode_steps
        for r, p in zip(reqs, prompts):
            ids = torch.tensor([p], device=cuda_device)
            want = model.generate(ids, max_new_tokens=8)[0, len(p):]
            assert r.output_tokens == want.tolist()


def _graph_engine(cuda_device, dtype, cache_dir, spec_k=0):
    from paddle_tpu_torch.inference.serving import (Request, ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(vocab_size=128, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=256)
    model = GPTForPretraining(cfg, device=cuda_device, seed=0,
                              dtype=getattr(torch, dtype)).eval()
    eng = ServingEngine(model, ServingConfig(
        page_size=16, max_batch=4, spec_k=spec_k,
        compile_cache_dir=cache_dir and str(cache_dir)), device=cuda_device)
    rng = np.random.default_rng(1)
    for n in (5, 16, 40):
        eng.submit(Request(rng.integers(1, 128, n).tolist(),
                           max_new_tokens=24))
    return eng, cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("program", ["decode", "verify"])
def test_captured_step_replays_the_eager_step_bit_identically(
        cuda_device, tmp_path, program, dtype):
    """Mid-serve, with live slots in the pools: the step's staged inputs
    run once eagerly and once as the captured graph's replay from the
    same pool state; outputs and pools agree bit for bit, and the replay
    adds its K1 launches (one per layer) to the counts."""
    from paddle_tpu_torch.inference.serving import engine as engine_mod
    from paddle_tpu_torch.inference.serving.compile_cache import \
        CapturedStep
    eng, cfg = _graph_engine(cuda_device, dtype, tmp_path,
                             spec_k=3 if program == "verify" else 0)
    for _ in range(4):
        eng.step()
    captured = eng._verify if program == "verify" else eng._decode
    assert isinstance(captured, CapturedStep)
    eager_fn = engine_mod.verify_step if program == "verify" \
        else engine_mod.decode_step
    _, args = eng.verify_capture_args() if program == "verify" \
        else eng.decode_capture_args()
    assert int(args[6].count_nonzero()) > 0      # live slots
    k0, v0 = eng.cache.k.clone(), eng.cache.v.clone()
    eager = [t.clone() for t in
             (eager_fn(*args) if program == "verify"
              else (eager_fn(*args),))]
    k_e, v_e = eng.cache.k.clone(), eng.cache.v.clone()
    eng.cache.k.copy_(k0)
    eng.cache.v.copy_(v0)
    before = ck.PAGED_ATTENTION.launches
    out = captured(*args)
    replayed = list(out) if program == "verify" else [out]
    torch.cuda.synchronize()
    assert ck.PAGED_ATTENTION.launches - before == cfg.num_layers
    for a, b in zip(eager, replayed):
        assert torch.equal(a, b)
    assert torch.equal(eng.cache.k, k_e) and torch.equal(eng.cache.v, v_e)


def test_graph_engine_serves_the_eager_tokens_with_replays_counted(
        cuda_device, tmp_path):
    """Graph replay against the eager steps, plain and speculative (fp32,
    exact): the first engine over a cache directory misses and checks
    each capture, a second one over it hits, an engine without one
    captures and checks as well, and an engine whose steps are set back
    to the eager functions gives the reference tokens. After init, K1
    launches = layers x dispatches, replays counted."""
    from paddle_tpu_torch.inference.serving import engine as engine_mod
    from paddle_tpu_torch.inference.serving.compile_cache import \
        CapturedStep
    results = {}
    for spec_k in (0, 3):
        for label, cache_dir in (("miss", tmp_path / f"k{spec_k}"),
                                 ("hit", tmp_path / f"k{spec_k}"),
                                 ("off", None), ("eager", None)):
            eng, cfg = _graph_engine(cuda_device, "float32", cache_dir,
                                     spec_k=spec_k)
            assert isinstance(eng._decode, CapturedStep)
            if label == "eager":
                eng._decode = engine_mod.decode_step
                eng._verify = engine_mod.verify_step
            if cache_dir is not None:
                c = eng.compile_cache
                programs = 2 if spec_k else 1
                assert c.graphs == programs
                assert (c.hits, c.misses) == ((0, programs)
                                              if label == "miss"
                                              else (programs, 0))
            before = ck.PAGED_ATTENTION.launches
            done = eng.run_until_done()
            assert ck.PAGED_ATTENTION.launches - before \
                == cfg.num_layers * eng.decode_steps
            results[spec_k, label] = sorted(
                (r.prompt_tokens, r.output_tokens) for r in done)
        assert results[spec_k, "miss"] == results[spec_k, "hit"] \
            == results[spec_k, "off"] == results[spec_k, "eager"]


def test_a_capture_that_fails_raises(cuda_device, tmp_path):
    from paddle_tpu_torch.inference.serving.compile_cache import (
        CompileCache, adopt)

    def fails_under_capture(x):
        y = x * 2
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("refuses to be captured")
        return y

    cache = CompileCache(str(tmp_path))
    x = torch.ones(8, device=cuda_device)
    with pytest.raises(RuntimeError, match="capture of probe failed"):
        adopt(fails_under_capture, (x,), "probe", cache=cache)
    assert cache.graphs == 0 and not list(tmp_path.iterdir())
    # the card is usable afterwards, and a capturable step captures
    got, _ = adopt(lambda t: t * 3, (x,), "probe", cache=cache)
    assert torch.equal(got(torch.full((8,), 2.0, device=cuda_device)),
                       torch.full((8,), 6.0, device=cuda_device))


def test_a_graph_that_replays_differently_raises(cuda_device, tmp_path):
    """The check holds a fresh graph to the eager step: a step whose
    captured form computes something else raises, and its manifest is
    not stored."""
    from paddle_tpu_torch.inference.serving.compile_cache import (
        CompileCache, adopt)

    def differs_under_capture(x):
        return x * (3 if torch.cuda.is_current_stream_capturing() else 2)

    cache = CompileCache(str(tmp_path))
    x = torch.ones(8, device=cuda_device)
    with pytest.raises(RuntimeError, match="replays differently"):
        adopt(differs_under_capture, (x,), "probe", cache=cache)
    assert (cache.graphs, cache.misses, cache.stores) == (1, 1, 0)
    assert not list(tmp_path.iterdir())


# K4/K5, packed varlen attention: (q lengths, k lengths or None for q's,
# d, causal). Tolerances as K2's and K3's. The last five sit at the edges
# of the tensor-core route's tiles: T = 163 (not a multiple of 4 or 64:
# the stream's last tile is ragged and lse's rows are not 16-byte
# aligned), a 64-row tile holding four segments, segments of one token, a
# causal segment starting mid-tile, and d = 256's 32-row steps on a
# ragged stream.
VARLEN_CASES = {
    "ragged_causal": ([700, 1800, 300, 1296], None, 64, True),
    "ragged_noncausal": ([700, 1800, 300, 1296], None, 64, False),
    "ragged_tail_causal": ([1, 977, 2400, 850], None, 64, True),
    "uniform_causal": ([512] * 6, None, 64, True),
    "d128_causal": ([130, 70, 300], None, 128, True),
    "d256_causal": ([130, 70, 300], None, 256, True),
    "cross_noncausal": ([1, 977, 2400, 850], [1024] * 4, 64, False),
    "empty_k_segment": ([40, 90, 33], [50, 0, 77], 64, False),
    "t163_causal": ([37, 70, 56], None, 64, True),
    "four_segments_one_tile": ([10, 20, 15, 30, 90, 3], None, 64, True),
    "unit_segments": ([1, 1, 1, 61, 1, 1, 70, 1], None, 64, True),
    "mid_tile_causal_d128": ([37, 100, 50], None, 128, True),
    "t163_d256_causal": ([37, 100, 26], None, 256, True),
}


def _varlen_args(case, dtype, device):
    lq, lk, d, causal = VARLEN_CASES[case]
    tdt = getattr(torch, dtype)
    q, k, v, cu_q, cu_k = varlen_inputs(lq, lk, h=2, d=d)
    q, k, v = (torch.from_numpy(x).to(device, tdt) for x in (q, k, v))
    cu_q = torch.from_numpy(cu_q).to(device)
    cu_k = cu_q if lk is None else torch.from_numpy(cu_k).to(device)
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(q.shape)).astype(np.float32)).to(device, tdt)
    return q, k, v, cu_q, cu_k, do, causal


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", list(VARLEN_CASES))
def test_varlen_fwd_kernel_matches_plain_version(cuda_device, case, dtype):
    q, k, v, cu_q, cu_k, _, causal = _varlen_args(case, dtype, cuda_device)
    before = ck.FLASH_VARLEN_FWD.launches
    o, lse = ck.flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, causal)
    again = ck.flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, causal)
    torch.cuda.synchronize()
    assert ck.FLASH_VARLEN_FWD.launches == before + 2
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    ro, rlse = ck.flash_attention_varlen_reference(q, k, v, cu_q, cu_k,
                                                   causal)
    tol = {"float32": 2e-5, "bfloat16": 2 ** -6, "float16": 2 ** -9}[dtype]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    # a row that sees no key writes +0
    assert not torch.signbit(o[(rlse == -1e30).T].float()).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", list(VARLEN_CASES))
def test_varlen_bwd_kernel_matches_plain_version(cuda_device, case, dtype):
    q, k, v, cu_q, cu_k, do, causal = _varlen_args(case, dtype, cuda_device)
    o, lse = ck.flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, causal)
    before = ck.FLASH_VARLEN_BWD.launches
    got = ck.flash_attention_varlen_bwd(q, k, v, o, lse, do, cu_q, cu_k,
                                        causal)
    again = ck.flash_attention_varlen_bwd(q, k, v, o, lse, do, cu_q, cu_k,
                                          causal)
    torch.cuda.synchronize()
    assert ck.FLASH_VARLEN_BWD.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ck.flash_attention_varlen_bwd_reference(q, k, v, o, lse, do, cu_q,
                                                  cu_k, causal)
    if dtype == "float32":
        tol = 5e-5
    else:
        tol = _ulp(max(float(r.float().abs().max()) for r in ref), dtype)
    for g, r, x in zip(got, ref, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=0)


def test_flash_attn_unpadded_runs_both_varlen_kernels(cuda_device):
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    q, k, v, cu, _, do, _ = _varlen_args("ragged_tail_causal", "float32",
                                         cuda_device)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    fwd, bwd = ck.FLASH_VARLEN_FWD.launches, ck.FLASH_VARLEN_BWD.launches
    out, none = flash_attn_unpadded(q, k, v, cu, cu, 2400, 2400, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert none is None
    assert ck.FLASH_VARLEN_FWD.launches == fwd + 1
    assert ck.FLASH_VARLEN_BWD.launches == bwd + 1
    o, lse = ck.flash_attention_varlen_reference(q.detach(), k.detach(),
                                                 v.detach(), cu, cu, True)
    want = ck.flash_attention_varlen_bwd_reference(
        q.detach(), k.detach(), v.detach(), o, lse, do, cu, cu, True)
    torch.testing.assert_close(out.detach(), o, atol=2e-5, rtol=0)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=5e-5, rtol=0)


def test_varlen_kernels_rerun_bit_identical_at_the_packed_shape(
        cuda_device):
    # the packed-attention workload of chip_smoke.py: 16,384 tokens of
    # documents of 32 to 2048 tokens, 12 heads of 64, causal, bf16
    rng = np.random.default_rng(0)
    lens = []
    while sum(lens) < 16384:
        lens.append(int(rng.integers(32, 2049)))
    lens[-1] -= sum(lens) - 16384
    q, k, v, cu, _ = varlen_inputs(lens, h=12, d=64)
    q, k, v = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
               for x in (q, k, v))
    cu = torch.from_numpy(cu).to(cuda_device)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)) \
        .to(cuda_device, torch.bfloat16)
    o, lse = ck.flash_attention_varlen_fwd(q, k, v, cu, cu, True)
    grads = ck.flash_attention_varlen_bwd(q, k, v, o, lse, do, cu, cu, True)
    for _ in range(2):
        o2, lse2 = ck.flash_attention_varlen_fwd(q, k, v, cu, cu, True)
        again = ck.flash_attention_varlen_bwd(q, k, v, o2, lse2, do, cu, cu,
                                              True)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert all(torch.isfinite(t).all() for t in (o, *grads))


def _misaligned(t):
    """t's values in a contiguous tensor that starts 2 bytes past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def test_varlen_wrappers_refuse_misaligned_bf16(cuda_device):
    q, k, v, cu, _, do, causal = _varlen_args("ragged_causal", "bfloat16",
                                              cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        ck.flash_attention_varlen_fwd(_misaligned(q), k, v, cu, cu, causal)
    with pytest.raises(ValueError, match="16-byte"):
        ck.flash_attention_varlen_fwd(q, k, _misaligned(v), cu, cu, causal)
    o, lse = ck.flash_attention_varlen_fwd(q, k, v, cu, cu, causal)
    with pytest.raises(ValueError, match="16-byte"):
        ck.flash_attention_varlen_bwd(q, k, v, o, lse, _misaligned(do), cu,
                                      cu, causal)
    with pytest.raises(ValueError, match="16-byte"):
        ck.flash_attention_varlen_bwd(q, _misaligned(k), v, o, lse, do, cu,
                                      cu, causal)


def test_varlen_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q, k, v, cu, _, do, _ = _varlen_args("uniform_causal", "float32",
                                         cuda_device)
    with pytest.raises(TypeError):
        ck.flash_attention_varlen_fwd(q, k, v, cu.long(), cu.long(), True)
    with pytest.raises(TypeError):
        ck.flash_attention_varlen_fwd(q.double(), k.double(), v.double(),
                                      cu, cu)
    with pytest.raises(ValueError):
        ck.flash_attention_varlen_fwd(q, k, v, cu.cpu(), cu.cpu())
    o, lse = ck.flash_attention_varlen_fwd(q, k, v, cu, cu, True)
    with pytest.raises(ValueError):
        ck.flash_attention_varlen_bwd(q, k, v, o, lse.T, do, cu, cu, True)


def _gate_after_in_place_write(device):
    """The causal varlen gate on cu_q and an equal cu_k, then again after
    cu_k is changed in place; returns both verdicts and the routed and
    dense outputs on the new values."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    from paddle_tpu_torch.nn.functional.attention import _unpadded_impl
    q, k, v, cu_q, _ = varlen_inputs([100, 260, 150], seed=3)
    q, k, v = (torch.from_numpy(x).to(device) for x in (q, k, v))
    cu_q = torch.from_numpy(cu_q).to(device)
    cu_k = cu_q.clone()
    before = ck.flash_attention_varlen_available(q, k, v, cu_q, cu_k, True)
    cu_k.copy_(torch.tensor([0, 120, 380, 510], dtype=torch.int32,
                            device=device))
    after = ck.flash_attention_varlen_available(q, k, v, cu_q, cu_k, True)
    got, _ = flash_attn_unpadded(q, k, v, cu_q, cu_k, 260, 260, causal=True)
    dense = _unpadded_impl(q, k, v, cu_q, cu_k, 0.125, True, 260, 260)
    return before, after, got, dense


def test_varlen_gate_sees_cu_changed_in_place(cuda_device):
    fwd = ck.FLASH_VARLEN_FWD.launches
    before, after, got, dense = _gate_after_in_place_write(cuda_device)
    assert before and not after
    assert ck.FLASH_VARLEN_FWD.launches == fwd   # the dense route ran
    torch.testing.assert_close(got, dense, atol=2e-5, rtol=0)


def test_varlen_gate_compares_inference_tensors_every_time(cuda_device):
    with torch.inference_mode():
        before, after, got, dense = _gate_after_in_place_write(cuda_device)
    assert before and not after
    torch.testing.assert_close(got, dense, atol=2e-5, rtol=0)


# -- the paddle.* surface on the card ----------------------------------------
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_on_paddle_tensors_launches_k2_k3_bit_equal(
        cuda_device, causal):
    """``F.flash_attention`` on paddle Tensors and ``paddle.grad`` through
    it launch K2 and K3 once each and give the torch-fed call's bits."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn((2, 256, 2, 64), generator=gen,
                               device=cuda_device).to(torch.bfloat16)
                   for _ in range(4))
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    out_t, _ = F.flash_attention(qt, kt, vt, causal=causal)
    want = (out_t, *torch.autograd.grad(out_t, (qt, kt, vt), do))
    ck.reset_launch_counts()
    qp, kp, vp = (paddle.to_tensor(t, stop_gradient=False)
                  for t in (q, k, v))
    out_p, _ = F.flash_attention(qp, kp, vp, causal=causal)
    assert isinstance(out_p, paddle.Tensor)
    grads = paddle.grad(out_p, [qp, kp, vp],
                        grad_outputs=paddle.to_tensor(do))
    assert ck.FLASH_FWD.launches == 1 and ck.FLASH_BWD.launches == 1
    for a, b in zip([out_p] + grads, want):
        assert torch.equal(a._value, b)


def test_to_tensor_with_no_place_lands_on_the_card(cuda_device):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    prev = place._current_place
    place._current_place = None
    try:
        assert paddle.get_device() == "gpu:0"
        for t in (paddle.to_tensor([1.0, 2.0]), paddle.ones([2]),
                  paddle.rand([2]), paddle.arange(3)):
            assert t._value.device == torch.device("cuda", 0)
            assert t.place == paddle.CUDAPlace(0)
    finally:
        place._current_place = prev


def test_paddle_save_load_keeps_bf16_on_the_card(cuda_device, tmp_path):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    x = torch.randn(64, 32, device="cuda").to(torch.bfloat16)
    prev = place._current_place
    paddle.set_device("gpu")
    try:
        path = str(tmp_path / "bf16.pdparams")
        paddle.save({"t": paddle.Tensor._wrap(x.clone()), "raw": x}, path)
        got = paddle.load(path)
    finally:
        place._current_place = prev
    for name in ("t", "raw"):
        v = got[name]._value
        assert v.is_cuda and v.dtype == torch.bfloat16, name
        assert torch.equal(v, x), name   # the bits, exactly


def test_dataloader_workers_leave_cuda_uninitialized(cuda_device):
    from _torch_dl_helpers import WorkerInfoDataset, record_init
    from paddle_tpu_torch.io import DataLoader
    torch.zeros(1, device="cuda")
    assert torch.cuda.is_initialized()
    dl = DataLoader(WorkerInfoDataset(), batch_size=4, num_workers=2,
                    worker_init_fn=record_init, timeout=120)
    rows = torch.cat(list(dl)).numpy()
    assert rows[:, 0].tolist() == list(range(32))
    # no worker initialized CUDA, at its init or after its samples
    assert (rows[:, 4] == 0).all() and (rows[:, 5] == 0).all()


_PP_ROUND_TRIP = """
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import comm_plane as cp
dist.init_parallel_env()
r = dist.get_rank()
assert dist.get_backend() == "gloo"
g = torch.Generator().manual_seed(0)
x = torch.randn(2, 1024, 768, generator=g).to("cuda", torch.bfloat16)
if r == 0:
    cp.pp_send(x, 1, "fwd", 0).wait()
    back = cp.pp_recv(1, "bwd", 0, device="cuda").result()
    assert back.is_cuda and back.dtype == torch.bfloat16
    assert torch.equal(back, x)
else:
    got = cp.pp_recv(0, "fwd", 0, device="cuda").result()
    assert got.is_cuda and torch.equal(got, x)
    cp.pp_send(got, 0, "bwd", 0).wait()
stats = cp.pp_stats()
assert stats["sends"] == 1 and stats["recvs"] == 1, stats
assert stats["bytes_sent"] == 2 * 1024 * 768 * 2 + 88, stats
print(f"rank{r} ok", flush=True)
dist.destroy_process_group()
"""


def test_pp_boundary_round_trip_through_the_host_on_gloo(cuda_device,
                                                         tmp_path):
    """One bf16 stage-boundary tensor ([2, 1024, 768], a microbatch's
    state) from rank 0 to rank 1 and back over gloo, two ranks sharing
    the card: gloo moves no CUDA tensor point to point, so the comm
    plane stages it through the host; the bits arrive unchanged, on the
    card, with one send and one receive counted a rank."""
    from _torch_dist_helpers import assert_ranks_ok, launch
    proc, logs = launch(tmp_path, _PP_ROUND_TRIP, nproc=2, timeout=240,
                        extra_env={"PADDLE_DISTRI_BACKEND": "gloo",
                                   "OMP_NUM_THREADS": "4"})
    assert_ranks_ok(proc, logs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["gqa", "noncausal"])
def test_flash_library_ops_match_plain_versions(cuda_device, case, dtype):
    """K2 and K3 through their ``torch.library`` ops
    (``paddle_tpu_torch::flash_fwd`` and ``flash_bwd``), forward and the
    registered backward, against the plain versions at the bounds above;
    the fake of each answers on meta tensors without a launch."""
    b, sq, sk, h, kh, d, causal = FLASH_CASES[case]
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda_device, tdt).requires_grad_(True)
               for x in flash_inputs(b, sq, sk, h, kh, d))
    scale = 1.0 / np.sqrt(d)
    ops = torch.ops.paddle_tpu_torch
    fwd, bwd = ck.FLASH_FWD.launches, ck.FLASH_BWD.launches
    o, lse = ops.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert ck.FLASH_FWD.launches == fwd + 1
    with torch.no_grad():
        ro, rlse = ck.flash_attention_reference(q, k, v, causal, scale)
    tol = 2e-5 if dtype == "float32" else \
        _ulp(float(ro.float().abs().max()), dtype)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    rng = np.random.default_rng(2)
    do = torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32)) \
        .to(cuda_device, tdt)
    dl = torch.from_numpy(rng.standard_normal(lse.shape).astype(
        np.float32)).to(cuda_device)
    got = torch.autograd.grad((o.float() * do.float()).sum()
                              + (lse * dl).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert ck.FLASH_BWD.launches == bwd + 1
    direct = ops.flash_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                           lse.detach(), do, dl, causal, scale)
    with torch.no_grad():
        ref = ck.flash_attention_bwd_reference(q, k, v, o, lse, do, dl,
                                               causal, scale)
    if dtype == "float32":
        tol = 2e-4 if kh != h else 5e-5
    else:
        tol = _ulp(max(float(r.float().abs().max()) for r in ref), dtype)
    for g, dg, r in zip(got, direct, ref):
        assert torch.equal(g, dg)
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=0)
    meta = [t.detach().to("meta") for t in (q, k, v)]
    mo, mlse = ops.flash_fwd(*meta, causal, scale)
    assert mo.shape == o.shape and mlse.shape == lse.shape \
        and mlse.dtype == torch.float32
    assert ck.FLASH_FWD.launches == fwd + 1 and \
        ck.FLASH_BWD.launches == bwd + 2
