"""The port's hand-written CUDA kernels on the card: each kernel held
against its plain PyTorch version, the wrappers' refusals, and the
serving engine's launches. Every test is marked ``cuda`` and skips where
no card is present.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: K1 fp32 at K*eps with K the longest context, bf16 at
48 * 2**-8; K2 fp32 at atol 2e-5, bf16 at 2**-6 (two ulps of an output
below 2: kernel and plain version both round one fp32 result). TF32 is
off for every fp32 comparison (the ``cuda_device`` fixture sets it).
"""
import numpy as np
import pytest
import torch

from _torch_helpers import (F32_EPS, cuda_device, flash_inputs,  # noqa: F401
                            paged_inputs)
from paddle_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda

BF16_PAGED_TOL = 48 * 2 ** -8
FLASH_CASES = {   # b, sq, sk, h, kh, d, causal
    "causal": (1, 128, 128, 2, 2, 64, True),
    "noncausal": (2, 128, 256, 2, 2, 64, False),
    "gqa": (1, 256, 256, 4, 2, 64, True),
    "mqa": (1, 128, 128, 4, 1, 64, True),
    "nonsquare_causal": (1, 128, 384, 2, 2, 64, True),
    "d128": (1, 256, 256, 2, 2, 128, True),
    "d256": (1, 128, 128, 2, 2, 256, True),
}


def _paged(ctxs, kq, dtype, device):
    q, kp, vp, bt, cl = paged_inputs(ctxs, kq)
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(q).to(device, tdt),
            torch.from_numpy(kp).to(device, tdt),
            torch.from_numpy(vp).to(device, tdt),
            torch.from_numpy(bt).to(device), torch.from_numpy(cl).to(device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ctxs,kq", [([5, 16, 17, 40, 64], 1),
                                     ([0, 20, 63, 127], 5),
                                     ([100], 3), ([0, 0], 1)],
                         ids=["ragged", "verify_k5", "seven_pages",
                              "inactive_batch"])
def test_paged_kernel_matches_plain_version(cuda_device, ctxs, kq, dtype):
    q, kp, vp, bt, cl = _paged(ctxs, kq, dtype, cuda_device)
    before = ck.PAGED_ATTENTION.launches
    got = ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert ck.PAGED_ATTENTION.launches == before + 1
    ref = ck.paged_attention_verify_reference(q, kp, vp, bt, cl)
    tol = (max(ctxs) + kq) * F32_EPS if dtype == "float32" \
        else BF16_PAGED_TOL
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
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
    with pytest.raises(TypeError):
        ck.paged_attention_verify_decode(q.half(), kp.half(), vp.half(),
                                         bt, cl)
    with pytest.raises(ValueError):
        ck.paged_attention_verify_decode(q.cpu(), kp, vp, bt, cl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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
    tol = 2e-5 if dtype == "float32" else 2 ** -6
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


def test_flash_kernel_is_forward_only(cuda_device):
    q, k, v = (torch.from_numpy(x).to(cuda_device)
               for x in flash_inputs(1, 128, 128, 2, 2, 64))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        ck.flash_attention_with_lse(q, k, v, causal=True)
    with torch.no_grad():
        ck.flash_attention_with_lse(q, k, v, causal=True)


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
