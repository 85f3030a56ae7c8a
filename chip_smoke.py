#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``paddle_tpu_torch/csrc``
with ``nvcc`` (one process per source, all at once; it fails if a
tensor-core kernel or K1's split-context pair spills registers) and holds
each kernel against its plain PyTorch version (K1 paged attention, K2
flash forward, K3 flash backward, K4 and K5 packed varlen forward and
backward, each in fp32, bf16 and fp16; K1 runs its scalar fp32 route and
its split-context bf16 and fp16 route, at serving's contexts and at the
edges of a split, twice for bit-identity; K2 to K5 run their scalar fp32
route and their tensor-core bf16 and fp16 route, and each 16-bit K2/K3
bound is held to twice the error of ``scaled_dot_product_attention``,
each 16-bit K4/K5 bound to twice that of PyTorch's varlen flash op, in
the same dtype against the same plain version, printed beside it). Then
it drives the port's main paths, each with the launch counts (in all and
by route) set to 0 just before it and read just after:

- serving: GPT-124M at full width (random weights from a seed) through
  ``ServingEngine`` with and without speculative decoding, each with the
  compile cache off (eager steps) and on (decode and verify replayed from
  CUDA graphs; the same tokens required, TPOT and tokens/s side by side),
  K1's device time per decode step from one more run under the profiler,
  and the fp32 engine's greedy tokens against the port's own ``generate``
  plus a full-width forward against the dense path;
- the serving fleet: GPT-124M in fp32 from a bundle, the port's
  ``TCPStore``, a ``ServingRouter``, replica A in this process with the
  compile cache on, and replica B spawned by ``Autoscaler.scale_out`` as
  a process through the replica CLI, finding A's cache entries; 16
  requests arrive every 50 ms, ``Autoscaler.scale_in`` drains a replica
  halfway, every request must come back ok with the tokens of one engine
  with the cache off, and K1 must launch once per layer and dispatch of
  A, graph replays counted (wall time, tokens/s, TTFT and TPOT p50,
  re-routed requests, cache hits, misses and graphs per replica);
- training: GPT-124M pretraining steps as ``bench.py`` runs them (batch
  16 x 1024 tokens, bf16 O2, AdamW at lr 1e-4) through
  ``CompiledTrainStep``, per call and through ``run_steps``; then a
  full-width, 2-layer fp32 step on the card against the same step on the
  CPU (loss and every gradient);
- eager fp16 AMP training: GPT-124M at the same widths through the
  upstream recipe (``amp.decorate`` O2 fp16, ``auto_cast``,
  ``GradScaler(2**15)``, AdamW under a warm-up/cosine schedule with a
  global-norm clip), 3 warm-up and 10 timed steps: tokens/s, the scale
  trajectory, skipped steps, the rate per step and peak memory, with K2
  and K3 launched once per layer and step on their fp16 route; then one
  2-layer fp16 O2 step against the same step in fp32 O0 on the card;
- scheduled training: GPT-124M through ``CompiledTrainStep`` at O2 bf16
  with ``examples/train_gpt.py``'s surface (cosine schedule, global-norm
  clip, ``FLAGS_check_nan_inf``, the StepMeter), per call and through
  ``run_steps`` (with the flag clear: ``run_steps`` refuses it), the
  rate each step read against the scheduler's sequence, the meter's
  tokens/s beside the host clock's, one
  ``use_rmsnorm=True`` step; then two eager fp32 steps of the recipe at
  O0 (the scaler enabled) on the card against the CPU, with LayerNorm and
  with RMSNorm;
- packed attention: ``F.flash_attn_unpadded`` forward and backward over
  16,384 packed tokens of ragged documents at GPT-124M's attention width
  (12 heads of 64), causal, bf16; then the same in fp32 against the
  per-segment plain versions;
- ERNIE-3.0-base pretraining (``ErnieForPretraining``, batch 16 x 512,
  bf16 O2, AdamW at lr 1e-4) and BERT-base finetuning
  (``BertForSequenceClassification``, batch 32 x 128, bf16 O2, AdamW at
  lr 2e-5), as ``benchmarks/matrix.py`` runs them, through
  ``CompiledTrainStep`` per call and through ``run_steps`` (K = 8 and
  16): step ms, tokens/s, sequences/s and MFU, with K2 and K3 non-causal
  once per layer and step; then each at full width and 2 layers in fp32
  on the card against the CPU (loss and every gradient; for ERNIE also a
  padded batch's forward on the dense path).

- the ``paddle.*`` eager surface: GPT-124M's eager fp16 AMP loop
  written as an upstream user writes it (``paddle.seed``,
  ``paddle.set_device("gpu")``, ``paddle.to_tensor`` batches, a loss that
  is a paddle Tensor, ``float(loss)``), bit-equal to the same steps fed
  torch tensors (losses, scales, every final parameter), with K2 and K3
  once per layer and step on their fp16 route and tokens/s both ways;
  ``paddle.grad`` through ``F.flash_attention`` on paddle Tensors at
  [16, 1024, 12, 64] bf16, bit-equal to the torch-fed call; and every
  entry of the op table on the card against the port's CPU result at its
  tolerance, with the random ops held by moments and seeded reruns;
- checkpoints and the data pipeline: GPT-124M as the scheduled path
  builds it, 8 uninterrupted steps (twice: the reruns must agree) against
  4 steps, ``paddle.save``, a model built from another seed,
  ``paddle.load`` and 4 more (losses, rates, parameters and AdamW
  moments bit-equal), the same through ``distributed.checkpoint`` with
  an asynchronous save taken while the next step runs,
  ``latest_checkpoint``, and a flipped shard byte that must fail the
  load and send ``latest_checkpoint`` to the earlier checkpoint; then
  ResNet-50 through ``Model.fit`` with ``ModelCheckpoint`` and two
  DataLoader worker processes, resumed from ``final`` in another seed's
  model, bit-equal to two uninterrupted epochs, each worker noting that
  it never initialized CUDA (save and load seconds and GB/s, the async
  save's blocked seconds, epoch-2 images/s with 0 and 2 workers).

Last, it times each kernel beside its bound, its plain version and,
where one exists, a PyTorch call that computes the same function (also
by their device time alone, which leaves out the host's launch gaps);
K1 also at a bytes-heavy shape (64 slots of 1024 tokens), K2 and K3
also at the ERNIE and BERT paths' non-causal shapes, and each kernel's
fp16 route (K2 and K3 at the fp16 AMP path's shape). Each
phase prints one JSON line; any failure raises and the script exits
non-zero. It needs a CUDA card: without one it exits 2 and prints no
result.

fp32 comparisons run with TF32 off in cuBLAS and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``).

The last line is ``{"ok": true, "device": {"platform": "gpu", "kind":
<torch.cuda.get_device_name(0)>, "count": <device count>}}``; the line
before it lists every kernel with its launches on the main paths, time,
bound, plain time and library time.
"""
from __future__ import annotations

import itertools
import json
import math
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12,
                  "float32": 67e12}   # dense, per type
F32_EPS = 2.0 ** -23


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters, warmup=3):
    """Mean ms per call from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_time_ms(fn, iters=20):
    """Mean device ms per call: every kernel and memset the calls put on
    the card, from ``torch.profiler`` over ``iters`` calls after one
    warm-up. Unlike ``cuda_time_ms`` it leaves out the host's launch gaps,
    which dominate calls shorter than their own launch path."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# -- phase 1 ------------------------------------------------------------------
def phase_environment(torch, ck):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = ck.build_kernels()
    wall = time.perf_counter() - t0
    ptxas = {name: ptxas_instantiations(log)
             for name, (_, log) in built.items()}
    emit({"phase": "environment", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_wall_s": wall,
          "build_s": {n: s for n, (s, _) in built.items()},
          "ptxas": ptxas})
    spilled = [f"{name}: {fn}" for name, fns in ptxas.items()
               for fn, info in fns.items()
               if spill_checked(fn) and info["spill_stores"]]
    if spilled:
        raise AssertionError(f"kernels spill: {spilled}")
    return smi


_KERNEL_NAME = re.compile(r"([a-z_]+kernel(?:_tc)?)(?:I(\w+?)E+v|E)")
_TEMPLATE_ARG = re.compile(r"13__nv_bfloat16|6__half|f|Li(\d+)")


def kernel_name(mangled):
    """``flash_bwd_dq_kernel_tc<64>`` from a mangled entry function's name,
    the bare name for a kernel that is not a template (None for a name
    that is not one of the port's kernels)."""
    m = _KERNEL_NAME.search(mangled)
    if not m:
        return None
    if m[2] is None:
        return m[1]
    args = [a[1] or {"f": "float", "6__half": "fp16"}.get(a[0], "bf16")
            for a in _TEMPLATE_ARG.finditer(m[2])]
    return f"{m[1]}<{', '.join(args)}>"


def spill_checked(fn):
    """Kernels that fail the run when they spill: the tensor-core ones
    (``*_tc``) and K1's split-context pair (``paged_split_kernel``,
    ``paged_combine_kernel``)."""
    base = fn.split("<")[0]
    return base.endswith("_tc") or base in ("paged_split_kernel",
                                            "paged_combine_kernel")


def ptxas_instantiations(log):
    """{kernel<dtype, d>: {"registers", "spill_stores"}} from ``nvcc
    -Xptxas=-v`` output: each entry function's properties line, then its
    spill line, then its "Used" line."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = kernel_name(ln)
        elif fn and "spill stores" in ln:
            out[fn] = {"spill_stores": int(re.search(
                r"(\d+) bytes spill stores", ln)[1])}
        elif fn and "Used" in ln and fn in out:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 ln)[1])
            fn = None
    return out


# -- phase 2 ------------------------------------------------------------------
def paged_case(torch, ctxs, kq, dtype, h=12, d=64, page=16, seed=0,
               spare=0):
    """Pools with each slot's pages scattered through them, tables padded
    with the null page; each active slot's table also holds ``spare``
    pages of random rows past its context. q is the column slice of a
    packed [B, KQ, 3*h*d] qkv, as the serving engine hands it to K1. Row
    j of slot b sees ctxs[b] + j tokens."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(ctxs)
    need = [(c + kq - 1 + page - 1) // page + spare if c else 0
            for c in ctxs]
    maxp = max(max(need), 1)
    npages = 1 + sum(need)
    perm = (torch.randperm(npages - 1, generator=g) + 1).tolist()
    tables, nxt = [], 0
    for n in need:
        tables.append(perm[nxt:nxt + n] + [0] * (maxp - n))
        nxt += n
    dev = "cuda"
    qkv = torch.randn(b, kq, 3 * h * d, generator=g).to(dev, dtype)
    q = qkv[..., :h * d].reshape(b, kq, h, d)
    kp = torch.randn(npages, page, h * d, generator=g).to(dev, dtype)
    vp = torch.randn(npages, page, h * d, generator=g).to(dev, dtype)
    bt = torch.tensor(tables, dtype=torch.int32, device=dev)
    cl = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, cl


def flash_case(torch, b, sq, sk, h, kh, d, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, sq, h, d, generator=g).to("cuda", dtype)
    k = torch.randn(b, sk, kh, d, generator=g).to("cuda", dtype)
    v = torch.randn(b, sk, kh, d, generator=g).to("cuda", dtype)
    return q, k, v


# ragged contexts up to 1024 (the model length), one inactive slot
PAGED_CTXS = {1: [0, 1, 17, 130, 511, 700, 1000, 1024],
              5: [0, 1, 17, 130, 511, 700, 1000, 1020]}
# K1 at the edges of the bf16 route's 256-token splits: (label, contexts,
# KQ, spare pages per table): a context one below, at and one above a
# split's length; KQ = 5 rows whose last visible token crosses a split;
# tables holding pages past their slots' contexts; all-inactive batches
PAGED_EDGE_CASES = [
    ("split_edges", [255, 256, 257, 511, 512, 513], 1, 0),
    ("verify_crosses_split", [252, 253, 254, 256, 0, 508], 5, 0),
    ("table_past_context", [100, 300, 0, 17, 256], 1, 20),
    ("table_past_context_k5", [100, 300, 0, 17, 256], 5, 20),
    ("all_inactive", [0, 0, 0], 1, 0),
    ("all_inactive_k5", [0, 0], 5, 0),
]
# the bytes-heavy timing shape: every slot at the model length
PAGED_BYTES_CTXS = [1024] * 64
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED, TRAIN_K = 16, 3, 10, 8
# (label, b, sq, sk, h, kh, d, causal); the last is the training path's
# attention, GPT-124M at batch 16
TRAIN_ATTENTION = ("gpt124m_train", TRAIN_BATCH, 1024, 1024, 12, 12, 64,
                   True)
# the encoder paths: ERNIE-3.0-base pretraining at batch 16 x 512 and
# BERT-base finetuning at batch 32 x 128 (benchmarks/matrix.py:95-166),
# each with its K for run_steps; their attention, non-causal
ERNIE_BATCH, ERNIE_SEQ, ERNIE_K = 16, 512, 8
BERT_BATCH, BERT_SEQ, BERT_K = 32, 128, 16
ERNIE_ATTENTION = ("ernie_noncausal", ERNIE_BATCH, ERNIE_SEQ, ERNIE_SEQ, 12,
                   12, 64, False)
BERT_ATTENTION = ("bert_noncausal", BERT_BATCH, BERT_SEQ, BERT_SEQ, 12, 12,
                  64, False)
FLASH_CASES = [
    ("gpt124m_causal", 1, 1024, 1024, 12, 12, 64, True),
    ("gqa_causal", 2, 256, 256, 12, 4, 64, True),
    ("nonsquare_causal", 1, 128, 384, 12, 12, 64, True),
    ("d128_causal", 1, 512, 512, 8, 8, 128, True),
    ("noncausal", 1, 256, 512, 12, 12, 64, False),
    TRAIN_ATTENTION,
    # the tile edges of the tensor-core route: one 128-row sequence (two
    # 64-row q tiles on one diagonal kv tile); the smallest offset the
    # gate admits (128: lengths are multiples of 128, so every offset is a
    # multiple of the 32-, 64- and 128-row tiles) at d = 128, where K3's
    # dk/dv pass steps 32 q rows over 64-row kv tiles; d = 256, 32-row kv
    # steps
    ("single_tile_causal", 1, 128, 128, 12, 12, 64, True),
    ("offset128_d128_causal", 1, 256, 384, 8, 8, 128, True),
    ("d256_causal", 1, 512, 512, 8, 8, 256, True),
    ERNIE_ATTENTION,
    BERT_ATTENTION,
]
# K3: the forward's cases and one with an lse cotangent
FLASH_BWD_CASES = FLASH_CASES + [
    ("dlse_causal", 1, 256, 256, 12, 12, 64, True)]


def ulp16(torch, x, dtype):
    """The spacing of ``dtype`` values at magnitude x: 8 significant bits
    for bf16, 11 for fp16."""
    return 2.0 ** (math.floor(math.log2(x)) -
                   (10 if dtype == torch.float16 else 7))


def sdpa_same_function(q, k, dlse=None):
    """True where ``scaled_dot_product_attention`` computes K2's (or, with
    no lse cotangent, K3's) function: kv heads equal to q heads and
    sq == sk, since its ``is_causal`` aligns the mask top-left and K2's
    bottom-right."""
    return k.shape[2] == q.shape[2] and k.shape[1] == q.shape[1] and \
        dlse is None


def sdpa_forward(torch, q, k, v, causal):
    """PyTorch's fused attention on [b, s, h, d] tensors."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal).transpose(1, 2)


def sdpa_backward(torch, q, k, v, do, causal):
    """(dq, dk, dv) of PyTorch's fused attention for the cotangent do."""
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)
    grads = torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))
    return tuple(g.transpose(1, 2) for g in grads)


def hold_bf16_to_library(rows):
    """Each 16-bit (bf16 or fp16) K2/K3 (or K4/K5) row's bound is its
    rounding bound, and no looser than twice the largest error of the
    library call against the same plain version at that kernel, d and
    dtype; then each row passes or fails."""
    lib = {}
    for r in rows:
        if r.get("library_max_abs_err") is not None:
            key = (r["kernel"], r["d"], r["dtype"])
            lib[key] = max(lib.get(key, 0.0), r["library_max_abs_err"])
    for r in rows:
        key = (r["kernel"], r["d"], r["dtype"])
        if key not in lib:
            raise AssertionError(f"no library error at {key} to hold the "
                                 "bf16 bound to")
        r["library_bound"] = 2 * lib[key]
        r["tol"] = min(r["rounding_tol"], r["library_bound"])
        r["pass"] = r["max_abs_err"] <= r["tol"] and r["pass"]


def paged_kernel_case(torch, ck, label, ctxs, kq, dtype, spare=0):
    """K1 against its plain version in fp32 on the same (exactly widened)
    inputs, element by element: |got - ref| <= atol + rtol * |ref|. atol
    is fp32's error over K terms (K the longest context), times the
    largest |v| for bf16 and fp16; rtol is 0 for fp32, 2^-8 for bf16 and
    2^-11 (fp16's eps) for fp16, the half ulp of rounding the output
    once. The rows of every inactive slot are
    exactly +0, and a rerun gives the same bits."""
    q, kp, vp, bt, cl = paged_case(torch, ctxs, kq, dtype, spare=spare)
    got = ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
    again = ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    ref = ck.paged_attention_verify_reference(q.float(), kp.float(),
                                              vp.float(), bt, cl)
    atol = (max(ctxs) + kq) * F32_EPS
    rtol = 0.0
    if dtype != torch.float32:
        atol *= float(vp.float().abs().max())
        rtol = 2.0 ** -11 if dtype == torch.float16 else 2.0 ** -8
    diff = (got.float() - ref).abs()
    over = float((diff / (atol + rtol * ref.abs())).max())
    inactive = [i for i, c in enumerate(ctxs) if c == 0]
    zero_rows_exact = all(bool((got[i] == 0).all()) and
                          not bool(torch.signbit(got[i].float()).any())
                          for i in inactive)
    same = torch.equal(got, again)
    return {"kernel": "paged_attention", "case": label, "kq": kq,
            "ctxs": ctxs, "spare_pages": spare, "dtype": str(dtype)[6:],
            "splits": ck.paged_splits(bt.shape[1], kp.shape[1])[1],
            "max_abs_err": float(diff.max()), "atol": atol, "rtol": rtol,
            "err_over_limit": over,
            "inactive_rows_exact_zero": zero_rows_exact,
            "deterministic": same,
            "pass": over <= 1.0 and zero_rows_exact and same}


def phase_kernels_vs_plain(torch, ck):
    results = []
    cases = [(f"serving_kq{kq}", ctxs, kq, 0)
             for kq, ctxs in PAGED_CTXS.items()] + PAGED_EDGE_CASES
    dtypes = (torch.bfloat16, torch.float16, torch.float32)
    for dtype in dtypes:
        for label, ctxs, kq, spare in cases:
            results.append(paged_kernel_case(torch, ck, label, ctxs, kq,
                                             dtype, spare))
    for dtype in dtypes:
        rows = [flash_fwd_case(torch, ck, *case, dtype)
                for case in FLASH_CASES]
        rows += [flash_bwd_case(torch, ck, *case, dtype)
                 for case in FLASH_BWD_CASES]
        if dtype != torch.float32:
            hold_bf16_to_library(rows)
        results.extend(rows)
    for dtype in dtypes:
        rows = [row for case in VARLEN_CASES
                for row in varlen_kernel_cases(torch, ck, case, dtype)]
        if dtype != torch.float32:
            hold_bf16_to_library(rows)
        results.extend(rows)
    emit({"phase": "kernels_vs_plain", "cases": results})
    bad = [r for r in results if not r["pass"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    return results


def flash_bwd_inputs(torch, ck, b, sq, sk, h, kh, d, causal, dtype, dlse,
                     seed=0):
    """q, k, v, o, lse, do and (for dlse) an lse cotangent on the card."""
    q, k, v = flash_case(torch, b, sq, sk, h, kh, d, dtype, seed)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    do = torch.randn(b, sq, h, d, generator=g).to("cuda", dtype)
    dl = torch.randn(b, h, sq, generator=g).to("cuda") if dlse else None
    o, lse = ck.flash_attention_with_lse(q, k, v, causal=causal)
    return q, k, v, o, lse, do, dl


def flash_fwd_case(torch, ck, label, b, sq, sk, h, kh, d, causal, dtype):
    """K2 against its plain version, twice for bit-identity. fp32: the
    JAX package's flash-forward tolerance, 2e-5. bf16 and fp16: one ulp
    at the largest |o|: the kernel rounds p to the 16-bit type before P V
    (each weight off by at most half an ulp of itself, errors that average
    out along the row) and rounds o once (half an ulp), where the library
    rounds too; ``hold_bf16_to_library`` then holds it to twice the
    library's error.
    lse (fp32 from exact 16-bit products and the fp32 p) at 1e-4."""
    q, k, v = flash_case(torch, b, sq, sk, h, kh, d, dtype)
    o, lse = ck.flash_attention_with_lse(q, k, v, causal=causal)
    o2, lse2 = ck.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ro, rlse = ck.flash_attention_reference(q, k, v, causal=causal)
    err_o, err_lse = max_err(o, ro), max_err(lse, rlse)
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    row = {"kernel": "flash_fwd", "case": label, "d": d,
           "dtype": str(dtype)[6:], "max_abs_err": err_o,
           "lse_max_abs_err": err_lse, "lse_tol": 1e-4,
           "deterministic": same}
    if dtype == torch.float32:
        row["tol"] = 2e-5
        row["pass"] = err_o <= 2e-5 and err_lse <= 1e-4 and same
        return row
    row["rounding_tol"] = ulp16(torch, float(ro.float().abs().max()), dtype)
    row["library_max_abs_err"] = max_err(
        sdpa_forward(torch, q, k, v, causal), ro) \
        if sdpa_same_function(q, k) else None
    row["pass"] = err_lse <= 1e-4 and same
    return row


def flash_bwd_case(torch, ck, label, b, sq, sk, h, kh, d, causal, dtype):
    """K3 against its plain version, twice for bit-identity. fp32: the
    JAX package's flash-backward bounds (atol 5e-5, 2e-4 where kv heads
    are shared). bf16 and fp16: one ulp at the outputs' largest magnitude:
    the kernel rounds p before P^T do and ds before dS^T q and dS K (each
    off by at most half an ulp of itself, errors that average out over
    the summed rows) and rounds dq, dk, dv once (half an ulp), where the
    library rounds too; ``hold_bf16_to_library`` then holds it to twice
    the library's error."""
    args = flash_bwd_inputs(torch, ck, b, sq, sk, h, kh, d, causal, dtype,
                            dlse=label.startswith("dlse"))
    got = ck.flash_attention_bwd(*args, causal=causal)
    again = ck.flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    ref = ck.flash_attention_bwd_reference(*args, causal=causal)
    errs = [max_err(a, r) for a, r in zip(got, ref)]
    same = all(torch.equal(a, r) for a, r in zip(got, again))
    row = {"kernel": "flash_bwd", "case": label, "d": d,
           "dtype": str(dtype)[6:], "max_abs_err": max(errs),
           "dq_dk_dv_err": errs, "deterministic": same}
    if dtype == torch.float32:
        row["tol"] = 2e-4 if kh != h else 5e-5
        row["pass"] = max(errs) <= row["tol"] and same
        return row
    q, k, v, _, _, do, dl = args
    row["rounding_tol"] = ulp16(torch, max(float(r.float().abs().max())
                                           for r in ref), dtype)
    row["library_max_abs_err"] = max(
        max_err(a, r) for a, r in
        zip(sdpa_backward(torch, q, k, v, do, causal), ref)) \
        if sdpa_same_function(q, k, dl) else None
    row["pass"] = same
    return row


# K4/K5: (label, q lengths, k lengths or None for cu_k is cu_q, d, causal),
# 12 heads; the cross-attention case has a ragged q stream (T = 4228)
# against 4 x 1024 keys; d = 256 steps 32 rows in the tensor-core K4 and
# in K5's passes; the empty k segment leaves 90 q rows that see no key
# (T = 163, so lse's rows are not 16-byte aligned)
VARLEN_CASES = [
    ("ragged_causal", [700, 1800, 300, 1296], None, 64, True),
    ("ragged_noncausal", [700, 1800, 300, 1296], None, 64, False),
    ("ragged_tail_causal", [1, 977, 2400, 850], None, 64, True),
    ("uniform_causal", [512] * 6, None, 64, True),
    ("d128_causal", [700, 1800, 300, 1296], None, 128, True),
    ("d256_causal", [700, 1800, 300, 1296], None, 256, True),
    ("cross_noncausal", [1, 977, 2400, 850], [1024] * 4, 64, False),
    ("empty_k_segment", [40, 90, 33], [50, 0, 77], 64, False),
]
PACKED_TOKENS, PACKED_HEADS, PACKED_DIM = 16384, 12, 64
PACKED_WARMUP, PACKED_TIMED = 3, 10


def packed_lengths(total=PACKED_TOKENS, seed=0):
    """Document lengths drawn from ``numpy.random.default_rng(seed)
    .integers(32, 2049)`` until they reach ``total``; the last is cut to
    fit. Ragged, not multiples of 64 or 128, so segments straddle tiles."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.integers(32, 2049)))
    lens[-1] -= sum(lens) - total
    return lens


def visible_pairs(lq, lk, causal):
    """(q, kv) pairs one head sees: L (L + 1) / 2 per segment when causal
    (cu_q == cu_k), Lq * Lk per segment otherwise."""
    if causal:
        return sum(n * (n + 1) // 2 for n in lq)
    return sum(a * b for a, b in zip(lq, lk))


def varlen_case(torch, lq, lk, h, d, dtype, seed=0):
    """q, k, v, do and int32 cu_seqlens on the card; cu_k is cu_q itself
    when ``lk`` is None."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    tk = sum(lq if lk is None else lk)
    q = torch.randn(sum(lq), h, d, generator=g).to("cuda", dtype)
    k = torch.randn(tk, h, d, generator=g).to("cuda", dtype)
    v = torch.randn(tk, h, d, generator=g).to("cuda", dtype)
    do = torch.randn(sum(lq), h, d, generator=g).to("cuda", dtype)

    def cu(lens):
        return torch.tensor([0, *itertools.accumulate(lens)],
                            dtype=torch.int32, device="cuda")

    cu_q = cu(lq)
    return q, k, v, do, cu_q, cu_q if lk is None else cu(lk)


def varlen_library_fwd(torch, q, k, v, cu_q, cu_k, max_q, max_k, causal):
    """PyTorch's varlen flash forward (``torch.ops.aten.
    _flash_attention_forward`` with cum_seq_q / cum_seq_k): (o, lse,
    philox seed, philox offset, debug mask)."""
    return torch.ops.aten._flash_attention_forward(
        q, k, v, cu_q, cu_k, max_q, max_k, 0.0, causal, False,
        scale=1.0 / math.sqrt(q.shape[-1]))


def varlen_library_bwd(torch, do, q, k, v, fwd, cu_q, cu_k, max_q, max_k,
                       causal):
    """(dq, dk, dv) of PyTorch's varlen flash op from its forward's
    outputs ``fwd``."""
    return torch.ops.aten._flash_attention_backward(
        do, q, k, v, fwd[0], fwd[1], cu_q, cu_k, max_q, max_k, 0.0, causal,
        fwd[2], fwd[3], scale=1.0 / math.sqrt(q.shape[-1]))[:3]


def varlen_library(torch, q, k, v, do, cu_q, cu_k, lq, lk, causal):
    """(o, (dq, dk, dv)) of PyTorch's varlen flash op for the cotangent
    do, or None where it does not compute K4's function: a q segment
    whose k segment is empty."""
    lk = lq if lk is None else lk
    if any(a and not b for a, b in zip(lq, lk)):
        return None
    fwd = varlen_library_fwd(torch, q, k, v, cu_q, cu_k, max(lq), max(lk),
                             causal)
    return fwd[0], varlen_library_bwd(torch, do, q, k, v, fwd, cu_q, cu_k,
                                      max(lq), max(lk), causal)


def varlen_kernel_cases(torch, ck, case, dtype):
    """K4 and K5 against their plain versions, each run twice for
    bit-identity; K5's inputs are K4's o and lse, as K3's are K2's. bf16
    rows also carry the varlen library call's error against the same
    plain versions, which ``hold_bf16_to_library`` holds them to."""
    label, lq, lk, d, causal = case
    q, k, v, do, cu_q, cu_k = varlen_case(torch, lq, lk, 12, d, dtype)
    o, lse = ck.flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, causal)
    o2, lse2 = ck.flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, causal)
    args = (q, k, v, o, lse, do, cu_q, cu_k, causal)
    got = ck.flash_attention_varlen_bwd(*args)
    again = ck.flash_attention_varlen_bwd(*args)
    torch.cuda.synchronize()
    ro, rlse = ck.flash_attention_varlen_reference(q, k, v, cu_q, cu_k,
                                                   causal)
    ref = ck.flash_attention_varlen_bwd_reference(*args)
    # K4 as K2: fp32 2e-5, bf16 and fp16 two ulps of an output below 2,
    # lse 1e-4; K5 as K3: fp32 5e-5, 16-bit one ulp at the outputs'
    # largest magnitude
    tol = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6,
           torch.float16: 2.0 ** -9}[dtype]
    err_o, err_lse = max_err(o, ro), max_err(lse, rlse)
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    errs = [max_err(a, r) for a, r in zip(got, ref)]
    top = max(float(r.float().abs().max()) for r in ref)
    btol = 5e-5 if dtype == torch.float32 else ulp16(torch, top, dtype)
    bsame = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(a).all()) for a in (o, *got))
    dt = str(dtype)[6:]
    fwd = {"kernel": "flash_varlen_fwd", "case": label, "d": d, "dtype": dt,
           "max_abs_err": err_o, "lse_max_abs_err": err_lse, "tol": tol,
           "lse_tol": 1e-4, "deterministic": same,
           "pass": err_o <= tol and err_lse <= 1e-4 and same and finite}
    bwd = {"kernel": "flash_varlen_bwd", "case": label, "d": d, "dtype": dt,
           "max_abs_err": max(errs), "dq_dk_dv_err": errs, "tol": btol,
           "deterministic": bsame,
           "pass": max(errs) <= btol and bsame and finite}
    if dtype != torch.float32:
        lib = varlen_library(torch, q, k, v, do, cu_q, cu_k, lq, lk, causal)
        fwd["rounding_tol"], bwd["rounding_tol"] = tol, btol
        fwd["library_max_abs_err"] = max_err(lib[0], ro) if lib else None
        bwd["library_max_abs_err"] = max(
            max_err(a, r) for a, r in zip(lib[1], ref)) if lib else None
    return [fwd, bwd]


# -- phase 3 ------------------------------------------------------------------
def serving_requests(torch, vocab, seed=0):
    """8 prompts of 64..700 tokens; 4 share a 256-token prefix."""
    from paddle_tpu_torch.inference.serving import Request
    g = torch.Generator().manual_seed(seed)
    rand = lambda n: torch.randint(1, vocab, (n,), generator=g).tolist()
    prefix = rand(256)
    lens = [64, 300, 150, 420, 500, 600, 650, 700]
    prompts = [prefix + rand(n - 256) if i % 2 else rand(n)
               for i, n in enumerate(lens)]
    return [Request(p, max_new_tokens=32) for p in prompts]


def run_engine(torch, model, requests, ck=None, eager=False, prof=None,
               **cfg):
    """Serve ``requests`` through one engine; the stats count from after
    the engine's construction (its graph capture and check), K1's
    launches in that span among them when ``ck`` is given. ``eager``
    sets the engine's decode and verify back to the eager step functions
    (the reference the graphs are held to); ``prof`` is a profiler the
    serving alone runs under."""
    import contextlib
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.inference.serving import engine as engine_mod
    from paddle_tpu_torch.observability.metrics import percentile
    eng = ServingEngine(model, ServingConfig(page_size=16, max_batch=8,
                                             **cfg), device="cuda")
    if eager:
        eng._decode = engine_mod.decode_step
        eng._verify = engine_mod.verify_step
    torch.cuda.synchronize()
    before = ck.PAGED_ATTENTION.launches if ck is not None else 0
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for r in requests:
            # TTFT counts from the run's start, not from when the request
            # was built (before the engine and its capture)
            r.arrival_t = t0
            eng.submit(r)
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    new_tokens = sum(len(r.output_tokens) for r in requests)
    stats = {
        "requests": len(requests), "new_tokens": new_tokens,
        "wall_s": wall, "tokens_per_s": new_tokens / wall,
        "ttft_p50_ms": percentile([r.ttft_s * 1e3 for r in requests], 0.5),
        "tpot_p50_ms": percentile([r.tpot_s * 1e3 for r in requests
                                   if r.tpot_s is not None], 0.5),
        "dispatches": eng.decode_steps,
        "prefix_hit_requests": sum(r.prefix_hit_tokens > 0
                                   for r in requests),
    }
    if ck is not None:
        stats["paged_attention_launches"] = \
            ck.PAGED_ATTENTION.launches - before
    if eng.compile_cache is not None:
        c = eng.compile_cache
        stats["compile_cache"] = {"hits": c.hits, "misses": c.misses,
                                  "refusals": c.refusals,
                                  "graphs": c.graphs}
    return eng, stats


def phase_serving(torch, ck, smi):
    """GPT-124M bf16 serving, spec off and spec k = 4, each three ways:
    the eager steps (the reference), the engine's CUDA graphs (each
    checked at init), and the graphs with a compile cache directory (the
    spec-k4 engine finds the decode manifest the spec-off one stored).
    The same tokens every way, TPOT and tokens/s side by side, and K1
    once per layer and dispatch, replays counted. One more spec-off graph
    run under the profiler takes K1's launches and device time per
    decode step from the trace, and its launch count must equal the
    wrapper count."""
    import tempfile
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", dtype=torch.bfloat16,
                              seed=0).eval()
    # warm-up outside the measured run: cuBLAS handles, allocator
    run_engine(torch, model, [Request(list(range(1, 40)),
                                      max_new_tokens=4)])
    out = {"phase": "serving_bf16", "nvidia_smi": smi,
           "model": "gpt_small (GPT-124M), bf16, random weights seed 0"}
    launches = dispatches = 0
    tokens = {}
    ways = ("eager", "graphs", "cache_dir")
    with tempfile.TemporaryDirectory(prefix="compile_cache.") as cache_dir:
        for way in ways:
            for spec_k in (0, 4):
                spec = "spec_k4" if spec_k else "spec_off"
                label = f"{spec}_{way}"
                reqs = serving_requests(torch, cfg.vocab_size)
                torch.cuda.reset_peak_memory_stats()
                eng, stats = run_engine(
                    torch, model, reqs, ck=ck, spec_k=spec_k,
                    eager=way == "eager",
                    compile_cache_dir=cache_dir if way == "cache_dir"
                    else None)
                stats["peak_memory_bytes"] = \
                    torch.cuda.max_memory_allocated()
                if spec_k:
                    stats["verify_steps"] = eng.spec_verify_steps
                    stats["accepted_drafts"] = eng.spec_accepted_total
                out[label] = stats
                dispatches += eng.decode_steps
                launches += stats["paged_attention_launches"]
                tokens[spec, way] = [r.output_tokens for r in reqs]
                if any(len(r.output_tokens) != 32 for r in reqs):
                    raise AssertionError(f"{label}: a request did not get "
                                         "its 32 tokens")
                if stats["prefix_hit_requests"] < 1:
                    raise AssertionError(f"{label}: no prefix-cache hit")
    for metric in ("tpot_p50_ms", "tokens_per_s"):
        out[f"{metric}_eager_graphs_cache_dir"] = {
            k: [out[f"{k}_{way}"][metric] for way in ways]
            for k in ("spec_off", "spec_k4")}
    # K1 in the trace of one more spec-off graph run (its TPOT is not
    # reported: the profiler slows the host): CUPTI records the kernel
    # nodes a graph replay launches, and each K1 launch runs each of its
    # kernels once (bf16: the split-context pass, then the combine)
    reqs = serving_requests(torch, cfg.vocab_size)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    eng, stats = run_engine(torch, model, reqs, ck=ck, prof=prof)
    dispatches += eng.decode_steps
    launches += stats["paged_attention_launches"]
    k1 = {e.key: (e.count, e.self_device_time_total)
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "paged_" in e.key}
    out["paged_attention_device_ms_per_decode_step"] = \
        sum(us for _, us in k1.values()) / 1e3 / eng.decode_steps
    out["paged_attention_traced"] = {k: {"launches": n, "device_us": us}
                                     for k, (n, us) in k1.items()}
    out["profiled_decode_steps"] = eng.decode_steps
    want = cfg.num_layers * eng.decode_steps
    out["profiled_paged_attention_launches"] = {
        "wrapper": stats["paged_attention_launches"],
        "layers_x_dispatches": want}
    out["paged_attention_launches"] = launches
    out["dispatches"] = dispatches
    same = {f"{spec}_{way}": tokens[spec, way] == tokens[spec, "eager"]
            for spec, way in tokens}
    out["same_tokens_as_eager"] = same
    out["spec_on_off_same_tokens"] = \
        tokens["spec_off", "eager"] == tokens["spec_k4", "eager"]
    emit(out)
    if launches != cfg.num_layers * dispatches:
        raise AssertionError(
            f"paged attention launched {launches} times for {dispatches} "
            f"dispatches of {cfg.num_layers} layers")
    if not k1 or stats["paged_attention_launches"] != want \
            or any(n != want for n, _ in k1.values()):
        raise AssertionError(
            f"K1 in the trace {out['paged_attention_traced']}, counted "
            f"{stats['paged_attention_launches']} times, against "
            f"{want} = layers x dispatches")
    if not all(same.values()):
        raise AssertionError(f"tokens differ from the eager steps': "
                             f"{same}")


# -- phase 4 ------------------------------------------------------------------
def phase_exactness_fp32(torch, ck):
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", dtype=torch.float32,
                              seed=0).eval()
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (40, 128, 256, 333)]
    reqs = [Request(p, max_new_tokens=32) for p in prompts]
    run_engine(torch, model, reqs)
    mismatched = []
    flash_before = ck.FLASH_FWD.launches
    for r, p in zip(reqs, prompts):
        ids = torch.tensor([p], device="cuda")
        ref = model.generate(ids, max_new_tokens=32)[0, len(p):].tolist()
        if ref != r.output_tokens:
            mismatched.append(len(p))
    generate_flash = ck.FLASH_FWD.launches - flash_before
    ids = torch.randint(1, cfg.vocab_size, (1, 1024), generator=g) \
        .to("cuda")
    with torch.no_grad():
        before = ck.FLASH_FWD.launches
        logits = model(ids)
        torch.cuda.synchronize()
        forward_flash = ck.FLASH_FWD.launches - before
        # the first 1023 positions recomputed on the dense path (1023 is
        # not a multiple of 128, so the gate refuses the kernel)
        dense = model(ids[:, :1023])
    finite = bool(torch.isfinite(logits).all())
    err = max_err(logits[:, :1023], dense)
    out = {"phase": "exactness_fp32", "tf32": False,
           "engine_vs_generate_equal": not mismatched,
           "mismatched_prompt_lens": mismatched,
           "generate_flash_launches": generate_flash,
           "forward_flash_launches": forward_flash,
           "forward_shape": list(logits.shape), "forward_finite": finite,
           "forward_vs_dense_max_abs_err": err,
           "forward_vs_dense_tol": 1e-3}
    emit(out)
    if mismatched:
        raise AssertionError(f"fp32 engine tokens differ from generate for "
                             f"prompts of {mismatched} tokens")
    if forward_flash != cfg.num_layers:
        raise AssertionError(f"forward launched flash_fwd {forward_flash} "
                             f"times, not {cfg.num_layers}")
    if not finite or list(logits.shape) != [1, 1024, cfg.vocab_size]:
        raise AssertionError("forward logits not finite or mis-shaped")
    if err > 1e-3:
        raise AssertionError(f"forward disagrees with the dense path by "
                             f"{err}")


# -- phase 4b: the serving fleet ---------------------------------------------
def _first_line(proc, timeout):
    """The next stdout line of ``proc`` within ``timeout`` seconds, or
    None (the read runs on a daemon thread; a hung child cannot hang the
    caller)."""
    import queue
    import threading
    q = queue.Queue()
    threading.Thread(target=lambda: q.put(proc.stdout.readline()),
                     daemon=True).start()
    try:
        return q.get(timeout=timeout)
    except queue.Empty:
        return None


def _published_counters(client, rank, names):
    """{counter: value} from the registry snapshot ``rank`` last published
    through the membership store (``observability.metrics.publish``)."""
    from paddle_tpu_torch.observability import metrics
    try:
        raw = client.get(f"{metrics._PUBLISH_PREFIX}/r{rank}").decode()
        snap = json.loads(raw)["metrics"]
    except (KeyError, ValueError):
        return {n: None for n in names}
    return {n: sum(s["value"] for s in snap.get(n, {}).get("series", []))
            for n in names}


def _token_gap(torch, model, prompt, got, want):
    """Where two greedy continuations of ``prompt`` part: the first
    differing position and the reference model's top-2 logit gap there."""
    pos = next(i for i, (a, b) in enumerate(zip(got + [None], want + [None]))
               if a != b)
    ids = torch.tensor([prompt + want[:pos]], device="cuda")
    with torch.no_grad():
        top = model(ids)[0, -1].float().topk(2).values
    return {"position": pos, "got": got[pos:pos + 4],
            "want": want[pos:pos + 4],
            "top2_logit_gap": float(top[0] - top[1])}


def phase_serving_fleet(torch, ck, smi):
    """GPT-124M fp32 served by a fleet on the one card: the port's
    ``TCPStore`` server in this process, a ``ServingRouter``, replica A on
    a thread here with the compile cache on, and replica B, which
    ``Autoscaler.scale_out`` spawns as a real process through the replica
    CLI (``--device cuda``, the same cache through
    ``PADDLE_SERVE_COMPILE_CACHE``). 16 requests go through the router;
    after half of them complete, ``Autoscaler.scale_in`` drains the least
    loaded replica (A when the loads allow it). Every request must come
    back ok with the tokens of one in-process engine on the same weights
    with the cache off, and K1 must have launched once per layer and
    dispatch of A, its graph replays counted."""
    import os
    import shutil
    import signal
    import tempfile
    import threading
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.inference.serving import (
        Autoscaler, AutoscalerConfig, EngineHarness, ServingConfig,
        ServingEngine, ServingReplica, ServingRouter, fleet, save_bundle)
    from paddle_tpu_torch.observability.metrics import percentile
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", dtype=torch.float32,
                              seed=0).eval()
    reqs = serving_requests(torch, cfg.vocab_size, seed=0) \
        + serving_requests(torch, cfg.vocab_size, seed=1)
    prompts = [r.prompt_tokens for r in reqs]
    out = {"phase": "serving_fleet", "nvidia_smi": smi,
           "model": "gpt_small (GPT-124M), fp32, random weights seed 0",
           "tf32": False}
    # the reference: one in-process engine on the same weights, cache off,
    # at the replicas' configuration (ServingConfig's defaults)
    ref = ServingEngine(model, ServingConfig(), device="cuda")
    for r in reqs:
        ref.submit(r)
    ref.run_until_done()
    want = [r.output_tokens for r in reqs]
    del ref
    tmp = tempfile.mkdtemp(prefix="serving_fleet.")
    procs, stop_a = [], threading.Event()
    server = client = conn_a = thread_a = None
    try:
        t0 = time.perf_counter()
        bundle = os.path.join(tmp, "bundle")
        digest = save_bundle(model, bundle)
        out["bundle_save_s"] = time.perf_counter() - t0
        cache_dir = os.path.join(tmp, "compile_cache")
        server = TCPStore(port=0, is_master=True)
        client = TCPStore(port=server.port)
        fleet.publish_bundle(client, fleet.current_generation(client),
                             bundle, digest)
        router = ServingRouter(client, hb_timeout=2.0, poll=0.01)
        # replica A: in this process, its graphs captured before it
        # attaches (the capture checks each against the eager step)
        t0 = time.perf_counter()
        eng_a = ServingEngine(model, ServingConfig(
            compile_cache_dir=cache_dir), device="cuda")
        out["replica_a_engine_init_s"] = time.perf_counter() - t0
        conn_a = TCPStore(port=server.port)
        rep_a = ServingReplica(conn_a, EngineHarness(eng_a), poll=0.002,
                               hb_interval=0.2, stop=stop_a)
        rep_a.attach(bundle_sha=digest)
        rc = {}
        thread_a = threading.Thread(
            target=lambda: rc.__setitem__("a", rep_a.run()), daemon=True)
        thread_a.start()
        b_log = os.path.join(tmp, "replica_b.log")
        spawned = {}

        def spawn():
            env = dict(os.environ, PYTHONPATH=root,
                       PADDLE_SERVE_COMPILE_CACHE=cache_dir)
            t_spawn = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "paddle_tpu_torch.inference.serving.replica",
                 "--store", f"127.0.0.1:{server.port}", "--device", "cuda",
                 "--poll", "0.002", "--hb-interval", "0.2",
                 "--name", "replica_b"],
                cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=open(b_log, "w"), text=True)
            procs.append(proc)
            line = _first_line(proc, 300)
            if not line or not line.startswith("REPLICA_ID="):
                raise AssertionError(
                    f"replica B did not attach ({line!r}): "
                    f"{open(b_log).read()[-3000:]}")
            spawned["id"] = int(line.strip().split("=", 1)[1])
            spawned["attach_s"] = time.perf_counter() - t_spawn

        scaler = Autoscaler(router, spawn=spawn, config=AutoscalerConfig(
            min_replicas=1, max_replicas=2, cooldown_s=0.0))
        if not scaler.scale_out("forced"):
            raise AssertionError("the autoscaler did not spawn replica B")
        b_id = spawned["id"]
        out["replica_b_spawn_to_attach_s"] = spawned["attach_s"]
        # B publishes its registry on its first serve-loop beat and then
        # on the heartbeat cadence (and retires it if it drains): read its
        # cache counters once it has published
        names = ("serving_compile_cache_hits",
                 "serving_compile_cache_misses",
                 "serving_compile_cache_refusals",
                 "serving_compile_cache_graphs")
        deadline = time.perf_counter() + 30.0
        b_cache = _published_counters(
            client, fleet.REPLICA_RANK_BASE + b_id, names)
        while b_cache[names[0]] is None and time.perf_counter() < deadline:
            time.sleep(0.05)
            b_cache = _published_counters(
                client, fleet.REPLICA_RANK_BASE + b_id, names)
        # from here on, the launches in this process are replica A's
        k1_before = ck.PAGED_ATTENTION.launches
        steps_before = eng_a.decode_steps
        t0 = time.perf_counter()
        rids = []
        for p in prompts:
            # open loop, one arrival every 50 ms: the replicas publish
            # their occupancy between arrivals, which the router balances
            rids.append(router.submit(p, max_new_tokens=32))
            t_next = time.perf_counter() + 0.05
            while time.perf_counter() < t_next:
                router.poll()
                time.sleep(router.poll_interval)
        while sum(rid in router.results for rid in rids) < len(rids) // 2:
            router.poll()
            time.sleep(router.poll_interval)
        # halfway: wait (5 s at most) for A to rank least loaded, as the
        # autoscaler ranks replicas, then scale in
        rank = lambda v: (int(v.occ.get("running", 0))      # noqa: E731
                          + int(v.occ.get("waiting", 0)),
                          -v.free_pages, v.i)
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            views = {v.i: v for v in router._targets(router.discover())}
            if len(views) == 2 and rank(views[rep_a.replica_id]) \
                    < rank(views[b_id]):
                break
            router.poll()
            time.sleep(0.005)
        out["scaled_in_at_completed"] = sum(rid in router.results
                                            for rid in rids)
        victim = scaler.scale_in("forced")
        out["drained_replica"] = "A" if victim == rep_a.replica_id \
            else "B" if victim == b_id else victim
        res = router.await_results(rids, timeout=600)
        wall = time.perf_counter() - t0
        if victim == rep_a.replica_id:
            thread_a.join(timeout=60)
        k1 = ck.PAGED_ATTENTION.launches - k1_before
        a_steps = eng_a.decode_steps - steps_before
        statuses = {rid: r["status"] for rid, r in res.items()}
        got = [res[rid].get("tokens") for rid in rids]
        mismatched = [{"request": i, "prompt_len": len(prompts[i]),
                       "replica": res[rid].get("replica"),
                       **_token_gap(torch, model, prompts[i], got[i],
                                    want[i])}
                      for i, rid in enumerate(rids) if got[i] != want[i]]
        ttft = [res[rid]["ttft_ms"] for rid in rids
                if "ttft_ms" in res[rid]]
        tpot = []
        for rid in rids:
            r = res[rid]
            sub = json.loads(client.get(fleet.k_req(rid)).decode())
            n = len(r.get("tokens") or [])
            if n > 1 and "ttft_ms" in r:
                e2e_ms = (r["t_done_unix"] - sub["t_submit_unix"]) * 1e3
                tpot.append((e2e_ms - r["ttft_ms"]) / (n - 1))
        c = eng_a.compile_cache
        out.update({
            "requests": len(rids),
            "ok": sum(s == "ok" for s in statuses.values()),
            "statuses": sorted(set(statuses.values())),
            "tokens_equal_single_engine": not mismatched,
            "mismatched": mismatched,
            "wall_s": wall,
            "output_tokens": sum(len(g or []) for g in got),
            "tokens_per_s": sum(len(g or []) for g in got) / wall,
            "ttft_p50_ms": percentile(ttft, 0.5),
            "tpot_p50_ms": percentile(tpot, 0.5),
            "rerouted": sum(bool(router.requeues.get(rid)) for rid in rids),
            "served_by": {str(k): sum(res[rid].get("replica") == k
                                      for rid in rids)
                          for k in (rep_a.replica_id, b_id)},
            "replica_a_cache": {"hits": c.hits, "misses": c.misses,
                                "refusals": c.refusals,
                                "graphs": c.graphs},
            "replica_b_cache": {
                "hits": b_cache["serving_compile_cache_hits"],
                "misses": b_cache["serving_compile_cache_misses"],
                "refusals": b_cache["serving_compile_cache_refusals"],
                "graphs": b_cache["serving_compile_cache_graphs"]},
            "replica_a_dispatches": a_steps,
            "replica_a_graph_replays": getattr(eng_a._decode, "replays",
                                              None),
            "paged_attention_launches_replica_a": k1,
            "autoscaler": {"scale_outs": scaler.scale_outs,
                           "scale_ins": scaler.scale_ins}})
        emit(out)
        if out["ok"] != len(rids):
            raise AssertionError(f"fleet requests not all ok: {statuses}")
        if mismatched:
            raise AssertionError(f"fleet tokens differ from the single "
                                 f"engine's: {mismatched}")
        if not b_cache["serving_compile_cache_hits"]:
            raise AssertionError(f"replica B recorded no cache hit: "
                                 f"{b_cache}")
        if k1 != cfg.num_layers * a_steps or not a_steps:
            raise AssertionError(
                f"paged attention launched {k1} times for {a_steps} "
                f"dispatches of replica A ({cfg.num_layers} layers)")
        if victim not in (rep_a.replica_id, b_id):
            raise AssertionError(f"scale-in drained nothing ({victim})")
    finally:
        stop_a.set()
        if thread_a is not None:
            thread_a.join(timeout=60)   # A drains before its store closes
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        for c in (conn_a, client, server):
            if c is not None:
                c.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 5 ------------------------------------------------------------------
PEAK_BF16_FLOPS = PEAK_OPS_PER_S["bfloat16"]


def _token_batches(torch, vocab, shape, label_shape, label_range):
    """``batch(*lead)`` drawing (ids, labels) of shapes lead + ``shape``
    and lead + ``label_shape`` on the card from one
    ``numpy.random.default_rng(0)``: ids in [0, vocab), labels in [0,
    label_range)."""
    import numpy as np
    rng = np.random.default_rng(0)

    def batch(*lead):
        return tuple(torch.from_numpy(rng.integers(0, hi, lead + shp))
                     .to("cuda")
                     for hi, shp in ((vocab, shape),
                                     (label_range, label_shape)))

    return batch


def gpt124m_training(torch):
    """GPT-124M pretraining as ``bench.py`` runs it: fp32 parameters from
    seed 0, AdamW at lr 1e-4, a bf16 O2 ``CompiledTrainStep``. Returns
    (model, step, batch); ``batch(*lead)`` draws (ids, labels) of shape
    lead + (16, 1024) on the card from one ``numpy.random.default_rng(0)``.
    ``scripts/profile_torch_train_step.py`` traces this same workload."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = CompiledTrainStep(lambda ids, labels: model(ids, labels=labels)[1],
                             model, opt, amp_level="O2")
    shape = (TRAIN_BATCH, cfg.max_seq_len)
    return model, step, _token_batches(torch, cfg.vocab_size, shape, shape,
                                       cfg.vocab_size)


def ernie_config(**kw):
    """ERNIE-3.0-base as ``benchmarks/matrix.py:125-166`` builds it: vocab
    40000, hidden 768, 12 layers of 12 heads of 64, FFN 3072, 512
    positions, type vocab 4, task-type vocab 3, LayerNorm eps 1e-12, no
    dropout."""
    from paddle_tpu_torch.text.ernie import ErnieConfig
    return ErnieConfig(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0,
                       max_position_embeddings=ERNIE_SEQ, **kw)


def bert_config(**kw):
    """BERT-base as ``benchmarks/matrix.py:95-122`` builds it: vocab
    30522, hidden 768, 12 layers, FFN 3072, 512 positions, type vocab 2,
    no dropout."""
    from paddle_tpu_torch.text.bert import BertConfig
    return BertConfig(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0, **kw)


def ernie_pretraining(torch):
    """ERNIE-3.0-base pretraining as ``benchmarks/matrix.py:125-166`` runs
    it: ``ErnieForPretraining`` with fp32 parameters from seed 0, AdamW at
    lr 1e-4, a bf16 O2 ``CompiledTrainStep`` over ``lambda ids, l:
    net(ids, labels=l)[1]``; ids and labels of shape lead + (16, 512)
    drawn in [0, 40000). One cut: ``group_sharded_parallel(net, opt,
    "p_g_os")`` is left out; on one device it is the plain optimizer.
    Returns (model, step, batch) as ``gpt124m_training`` does."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.ernie import ErnieForPretraining
    cfg = ernie_config()
    model = ErnieForPretraining(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = CompiledTrainStep(lambda ids, l: model(ids, labels=l)[1], model,
                             opt, amp_level="O2")
    shape = (ERNIE_BATCH, ERNIE_SEQ)
    return model, step, _token_batches(torch, cfg.vocab_size, shape, shape,
                                       cfg.vocab_size)


def bert_finetune(torch):
    """BERT-base finetuning as ``benchmarks/matrix.py:95-122`` runs it:
    ``BertForSequenceClassification`` with 2 classes, fp32 parameters
    from seed 0, AdamW at lr 2e-5, a bf16 O2 ``CompiledTrainStep``; ids of
    shape lead + (32, 128) in [0, 30522) and one class in {0, 1} per
    sequence. Returns (model, step, batch) as ``gpt124m_training`` does."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.bert import BertForSequenceClassification
    cfg = bert_config()
    model = BertForSequenceClassification(cfg, num_classes=2, device="cuda",
                                          seed=0)
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters())
    step = CompiledTrainStep(lambda ids, y: model(ids, labels=y)[1], model,
                             opt, amp_level="O2")
    return model, step, _token_batches(torch, cfg.vocab_size,
                                       (BERT_BATCH, BERT_SEQ),
                                       (BERT_BATCH,), 2)


def flops_per_token(model, layers, hidden, seq):
    """6N + 12 L H S (N every parameter, the tied one once): the JAX
    package's count (``text/gpt.py`` ``flops_per_token``,
    ``benchmarks/matrix.py:159-166``), so MFU means the same in both."""
    n = sum(p.numel() for p in model.parameters())
    return 6 * n + 12 * layers * hidden * seq


# the training paths: (phase, workload, run_steps K, layers, hidden,
# description)
TRAINING_PATHS = {
    "gpt124m": ("training_bf16", gpt124m_training, TRAIN_K, 12, 768,
                "gpt_small (GPT-124M), fp32 params, O2 bf16 compute, "
                "AdamW lr 1e-4, random weights seed 0"),
    "ernie": ("ernie_pretraining_bf16", ernie_pretraining, ERNIE_K, 12, 768,
              "ErnieForPretraining, ERNIE-3.0-base (vocab 40000), fp32 "
              "params, O2 bf16 compute, AdamW lr 1e-4, random weights and "
              "tokens seed 0, no group_sharded_parallel"),
    "bert": ("bert_finetune_bf16", bert_finetune, BERT_K, 12, 768,
             "BertForSequenceClassification, BERT-base (vocab 30522), 2 "
             "classes, fp32 params, O2 bf16 compute, AdamW lr 2e-5, random "
             "weights and tokens seed 0"),
}


def phase_training_bf16(torch, ck, smi, path="gpt124m"):
    """One training path's workload: 3 warm-up steps, 10 timed calls, then
    one timed ``run_steps`` block of K; each step must launch K2 and K3
    once per layer."""
    phase, build, k, layers, hidden, describe = TRAINING_PATHS[path]
    model, step, batch = build(torch)
    ids, labels = batch()
    ids_k, labels_k = batch(k)
    b, seq = ids.shape
    tokens = b * seq
    per_token = flops_per_token(model, layers, hidden, seq)
    torch.cuda.reset_peak_memory_stats()
    before = {k_.name: k_.launches for k_ in ck.KERNELS}
    losses = [step(ids, labels) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(ids, labels) for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    per_call_s = (time.perf_counter() - t0) / TRAIN_TIMED
    t0 = time.perf_counter()
    block = step.run_steps(ids_k, labels_k)
    torch.cuda.synchronize()
    run_steps_s = (time.perf_counter() - t0) / k
    losses = [float(x) for x in losses] + block.tolist()
    launches = {k_.name: k_.launches - before[k_.name] for k_ in ck.KERNELS}
    steps = TRAIN_WARMUP + TRAIN_TIMED + k

    def rates(step_s):
        tps = tokens / step_s
        return {"step_ms": step_s * 1e3, "tokens_per_s": tps,
                "sequences_per_s": b / step_s,
                "mfu": tps * per_token / PEAK_BF16_FLOPS}

    out = {"phase": phase, "nvidia_smi": smi, "model": describe,
           "batch": b, "seq": seq,
           "num_parameters": sum(p.numel() for p in model.parameters()),
           "flops_per_token": per_token, "mfu_peak_flops": PEAK_BF16_FLOPS,
           "per_call": rates(per_call_s),
           f"run_steps_k{k}": rates(run_steps_s),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "steps": steps, "losses": losses, "launches": launches}
    emit(out)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a training loss is not finite: {losses}")
    want = layers * steps
    if launches["flash_bwd"] != want or launches["flash_fwd"] != want:
        raise AssertionError(
            f"{steps} steps of {layers} layers launched flash_fwd "
            f"{launches['flash_fwd']} and flash_bwd {launches['flash_bwd']} "
            f"times; want {want} each")


def _grads(model):
    """{name: gradient on the CPU, or None for a parameter the loss never
    reads}."""
    return {n: None if p.grad is None else p.grad.cpu()
            for n, p in model.named_parameters()}


def training_exactness_fp32(torch, ck, phase, describe, build, ids, labels,
                            mask=None):
    """One fp32 step (loss and every gradient) of a model at full width
    and 2 layers, built by ``build(device)`` from one seed: on the card
    through K2/K3 and on the CPU through their plain versions, on the same
    batch. With ``mask``, also one padded forward (the dense attention
    path) on each device. The loss within 1e-4, every gradient within 1e-4
    of its own largest entry (fp32 sums over the batch's tokens taken in
    different orders on the two devices; a gradient that is zero up to
    rounding, below 1e-6 of the largest entry, on both devices), the
    masked logits within 1e-4 of their largest entry."""
    results, models = {}, {}
    before = {k.name: k.launches for k in ck.KERNELS}
    for dev in ("cuda", "cpu"):
        models[dev] = model = build(dev)
        loss = model(ids.to(dev), labels=labels.to(dev))[1]
        loss.backward()
        results[dev] = (loss.item(), _grads(model))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k.name: k.launches - before[k.name]
                        for k in ck.KERNELS}
    loss_err = abs(results["cuda"][0] - results["cpu"][0])
    cpu_grads = results["cpu"][1]
    unread = sorted(n for n, g in cpu_grads.items() if g is None)
    unread_cuda = sorted(n for n, g in results["cuda"][1].items()
                         if g is None)
    # a gradient that is zero in exact arithmetic (k_proj's bias: it
    # shifts each row of scores by a constant, which softmax removes) is
    # rounding noise on both devices; it is held below 1e-6 of the
    # model's largest gradient entry, every other one relative to itself
    top = max(float(g.abs().max()) for g in cpu_grads.values()
              if g is not None)
    zero = sorted(n for n, g in cpu_grads.items()
                  if g is not None and float(g.abs().max()) <= 1e-6 * top)
    zero_ok = all(float(results["cuda"][1][n].abs().max()) <= 1e-6 * top
                  for n in zero)
    grad_rel = {n: max_err(g, cpu_grads[n]) /
                float(cpu_grads[n].abs().max())
                for n, g in results["cuda"][1].items()
                if g is not None and n not in zero}
    worst = max(grad_rel, key=grad_rel.get)
    out = {"phase": phase, "tf32": False, "model": describe,
           "batch": list(ids.shape),
           "loss_cuda": results["cuda"][0], "loss_cpu": results["cpu"][0],
           "loss_abs_err": loss_err, "loss_tol": 1e-4,
           "grad_max_rel_err": grad_rel[worst], "grad_worst": worst,
           "grad_rel_tol": 1e-4, "grads_zero_up_to_rounding": zero,
           "zero_tol_of_largest_grad": 1e-6, "params": len(cpu_grads),
           "params_without_gradient": unread, "launches": launches}
    masked_rel = None
    if mask is not None:
        with torch.no_grad():
            fwd_before = ck.FLASH_FWD.launches
            logits = {dev: m(ids.to(dev), attention_mask=mask.to(dev))
                      for dev, m in models.items()}
            masked_launches = ck.FLASH_FWD.launches - fwd_before
        masked_rel = max_err(logits["cuda"].cpu(), logits["cpu"]) / \
            float(logits["cpu"].abs().max())
        out.update(masked_rel_err=masked_rel, masked_rel_tol=1e-4,
                   masked_valid_tokens=mask.sum(1).tolist(),
                   masked_flash_launches=masked_launches)
    emit(out)
    layers = 2
    if launches["flash_fwd"] != layers or launches["flash_bwd"] != layers:
        raise AssertionError(f"the fp32 step launched {launches}")
    if unread != unread_cuda:
        raise AssertionError(f"parameters without a gradient differ: card "
                             f"{unread_cuda}, CPU {unread}")
    if loss_err > 1e-4 or grad_rel[worst] > 1e-4 or not zero_ok:
        raise AssertionError(f"card step differs from the CPU step: loss "
                             f"{loss_err}, {worst} {grad_rel[worst]}, zero "
                             f"up to rounding on the CPU {zero}")
    if mask is not None and (masked_rel > 1e-4
                             or out["masked_flash_launches"]):
        raise AssertionError(f"masked forward: {masked_rel} against the CPU, "
                             f"{out['masked_flash_launches']} flash launches")


def _seeded_ids(torch, vocab, shape, seed=1):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, vocab, shape))
            for _ in range(2))


def phase_training_exactness_fp32(torch, ck):
    """GPT at GPT-124M's widths, 2 layers, batch 2 x 1024."""
    from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12)
    ids, labels = _seeded_ids(torch, cfg.vocab_size, (2, cfg.max_seq_len))
    training_exactness_fp32(
        torch, ck, "training_exactness_fp32",
        "GPT-124M widths, 2 layers, fp32, batch 2 x 1024",
        lambda dev: GPTForPretraining(cfg, device=dev, seed=0), ids, labels)


def phase_ernie_exactness_fp32(torch, ck):
    """ERNIE-3.0-base's widths, 2 layers, batch 2 x 512; then a padded
    batch (400 and 512 real tokens) forward on the dense path."""
    from paddle_tpu_torch.text.ernie import ErnieForPretraining
    cfg = ernie_config(num_hidden_layers=2)
    ids, labels = _seeded_ids(torch, cfg.vocab_size, (2, ERNIE_SEQ))
    mask = (torch.arange(ERNIE_SEQ)[None] <
            torch.tensor([[400], [ERNIE_SEQ]])).long()
    training_exactness_fp32(
        torch, ck, "ernie_exactness_fp32",
        "ERNIE-3.0-base widths, 2 layers, fp32, batch 2 x 512",
        lambda dev: ErnieForPretraining(cfg, device=dev, seed=0), ids,
        labels, mask)


def phase_bert_exactness_fp32(torch, ck):
    """BERT-base's widths, 2 layers, 2 classes, batch 2 x 128."""
    from paddle_tpu_torch.text.bert import BertForSequenceClassification
    cfg = bert_config(num_hidden_layers=2)
    ids, _ = _seeded_ids(torch, cfg.vocab_size, (2, BERT_SEQ))
    labels = torch.tensor([0, 1])
    training_exactness_fp32(
        torch, ck, "bert_exactness_fp32",
        "BERT-base widths, 2 layers, 2 classes, fp32, batch 2 x 128",
        lambda dev: BertForSequenceClassification(cfg, num_classes=2,
                                                  device=dev, seed=0),
        ids, labels)


# -- phase 5b: the training surface -------------------------------------------
AMP_WARMUP, AMP_TIMED = 3, 10


def amp_schedule(lr):
    """The upstream eager AMP recipe's schedule at bench.py's learning
    rate: a 100-step linear warm-up into a cosine decay over 1000 steps."""
    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, 1000), 100, 0.0,
                           1e-4)


def eager_amp_steps(torch, model, ids, labels, steps, level, dtype,
                    sched, scaler, opt, sync=True):
    """``steps`` eager steps of the upstream recipe: under ``auto_cast``,
    ``scaler.scale(loss).backward()``, ``scaler.step(opt)``,
    ``opt.clear_grad()``, ``sched.step()``. Returns per step (loss, scale
    before the step, skipped, lr used, host seconds); a step is skipped
    when its gradients were not finite, which halves the scale."""
    from paddle_tpu_torch import amp
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        lr = opt.get_lr()
        scale = scaler._scale
        with amp.auto_cast(enable=level != "O0", level=level, dtype=dtype):
            _, loss = model(ids, labels=labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        skipped = scaler._scale < scale
        opt.clear_grad()
        sched.step()
        if sync:
            torch.cuda.synchronize()
        out.append((loss.item(), scale, skipped, lr,
                    time.perf_counter() - t0))
    return out


def gpt124m_fp16_amp(torch):
    """GPT-124M at bench.py's widths (vocab 50304, 12 layers of 12 x 64,
    batch 16 x 1024 drawn as ``gpt124m_training`` draws it) set up for the
    eager upstream AMP recipe: ``decorate(model, opt, level="O2",
    dtype="float16")``, AdamW under the warm-up/cosine schedule with
    ``ClipGradByGlobalNorm(1.0)``, ``GradScaler(init_loss_scaling=2**15)``.
    Returns (model, opt, sched, scaler, ids, labels);
    ``scripts/profile_torch_train_step.py`` traces this same workload."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    sched = amp_schedule(popt.lr)
    opt = popt.AdamW(learning_rate=sched, parameters=model.parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    ids, labels = _token_batches(torch, cfg.vocab_size,
                                 (TRAIN_BATCH, cfg.max_seq_len),
                                 (TRAIN_BATCH, cfg.max_seq_len),
                                 cfg.vocab_size)()
    return model, opt, sched, scaler, ids, labels


def phase_gpt124m_fp16_amp(torch, ck, smi):
    """``gpt124m_fp16_amp``'s recipe: 3 warm-up and 10 timed steps. Every
    step must launch K2 and K3 once per layer on their fp16 route, and
    every loss of a step the scaler did not skip must be finite."""
    model, opt, sched, scaler, ids, labels = gpt124m_fp16_amp(torch)
    layers = model.config.num_layers
    tokens = ids.numel()
    torch.cuda.reset_peak_memory_stats()
    before = {k.name: dict(k.route_launches) for k in ck.KERNELS}
    steps = eager_amp_steps(torch, model, ids, labels,
                            AMP_WARMUP + AMP_TIMED, "O2", "float16", sched,
                            scaler, opt)
    routes = {k.name: {r: n - before[k.name][r]
                       for r, n in k.route_launches.items()}
              for k in ck.KERNELS}
    timed = [s for *_, s in steps[AMP_WARMUP:]]
    step_s = sum(timed) / len(timed)
    n = len(steps)
    out = {"phase": "gpt124m_fp16_amp", "nvidia_smi": smi,
           "model": "gpt_small (GPT-124M), eager, decorate O2 float16, "
                    "auto_cast O2 float16, AdamW under LinearWarmup(Cosine"
                    "AnnealingDecay(1e-4, 1000), 100, 0, 1e-4), "
                    "ClipGradByGlobalNorm(1.0), GradScaler(2**15), random "
                    "weights seed 0",
           "batch": list(ids.shape), "steps": n,
           "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "tokens_per_s_each_step": [tokens / s for *_, s in steps],
           "losses": [l for l, *_ in steps],
           "scale": [sc for _, sc, *_ in steps] + [scaler._scale],
           "skipped_steps": [i for i, (_, _, sk, *_) in enumerate(steps)
                             if sk],
           "lr": [lr for *_, lr, _ in steps],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches_by_route": routes}
    emit(out)
    bad = [i for i, (l, _, sk, *_) in enumerate(steps)
           if not sk and not math.isfinite(l)]
    if bad:
        raise AssertionError(f"non-finite loss on steps the scaler kept: "
                             f"{bad}")
    want = layers * n
    for name in ("flash_fwd", "flash_bwd"):
        if routes[name] != {"fp32": 0, "bf16": 0, "fp16": want}:
            raise AssertionError(f"{n} steps of {layers} layers "
                                 f"launched {name} {routes[name]}; want "
                                 f"{want} on the fp16 route")
    if not all(p.dtype == torch.float16 for p in model.parameters()):
        raise AssertionError("decorate left a parameter that is not fp16")


SURFACE_WARMUP, SURFACE_TIMED = 2, 4
SURFACE_ATTENTION = (16, 1024, 12, 64)


def surface_amp_loop(torch, np_ids, np_labels, surface):
    """``gpt124m_fp16_amp``'s recipe (``eager_amp_steps``) from the same
    seed and batch. With ``surface`` it runs on the ``paddle.*`` surface
    as an upstream user writes it: ``paddle.seed(0)``,
    ``paddle.set_device("gpu")``, ids and labels from
    ``paddle.to_tensor``, so the model is called on paddle Tensors and
    its loss is one; without, the same steps are fed torch tensors.
    Returns (model, eager_amp_steps' rows, the scale after the last)."""
    import paddle_tpu_torch as paddle
    model, opt, sched, scaler, _, _ = gpt124m_fp16_amp(torch)
    if surface:
        paddle.seed(0)
        paddle.set_device("gpu")
        ids, labels = paddle.to_tensor(np_ids), paddle.to_tensor(np_labels)
    else:
        ids = torch.from_numpy(np_ids).to("cuda")
        labels = torch.from_numpy(np_labels).to("cuda")
    steps = eager_amp_steps(torch, model, ids, labels,
                            SURFACE_WARMUP + SURFACE_TIMED, "O2", "float16",
                            sched, scaler, opt)
    return model, steps, scaler._scale


def surface_flash_grad(torch, causal):
    """``paddle.grad`` through ``F.flash_attention`` on paddle Tensors at
    [16, 1024, 12, 64] bf16 against the torch-fed call on the same
    inputs: (out, dq, dk, dv) must be bit-equal."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(SURFACE_ATTENTION, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    out_t, _ = F.flash_attention(qt, kt, vt, causal=causal)
    want = (out_t, *torch.autograd.grad(out_t, (qt, kt, vt), do))
    qp, kp, vp = (paddle.to_tensor(t, stop_gradient=False)
                  for t in (q, k, v))
    out_p, _ = F.flash_attention(qp, kp, vp, causal=causal)
    grads = paddle.grad(out_p, [qp, kp, vp],
                        grad_outputs=paddle.to_tensor(do))
    got = [out_p._value] + [g._value for g in grads]
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    if not all(equal):
        raise AssertionError(f"paddle.grad through flash_attention "
                             f"(causal={causal}) is not bit-equal to the "
                             f"torch-fed call: out, dq, dk, dv equal "
                             f"{equal}")
    return equal


def phase_paddle_surface(torch, ck, smi):
    """The ``paddle.*`` eager surface on the card, three parts:

    1. GPT-124M's eager fp16 AMP loop (``surface_amp_loop``) on paddle
       Tensors and on torch tensors, from the same seed and batch: the
       losses, the scale trajectory and every final parameter must be
       bit-equal, and the surface loop must launch K2 and K3 once per
       layer and step on their fp16 route; tokens/s both ways;
    2. ``paddle.grad`` through ``F.flash_attention`` (``surface_flash_grad``),
       causal and not;
    3. the op sweep: every entry of the op table on the card against the
       port's own CPU result at the entry's tolerance (fp32, TF32 off;
       gradients in fp64 where the entry has them), and the random ops by
       their moments and seeded reruns."""
    from paddle_tpu_torch.ops import sweep
    from paddle_tpu_torch.text.gpt import gpt_small
    cfg = gpt_small()
    ids, labels = _token_batches(torch, cfg.vocab_size,
                                 (TRAIN_BATCH, cfg.max_seq_len),
                                 (TRAIN_BATCH, cfg.max_seq_len),
                                 cfg.vocab_size)()
    np_ids, np_labels = ids.cpu().numpy(), labels.cpu().numpy()
    before = {k.name: dict(k.route_launches) for k in ck.KERNELS}
    s_model, s_steps, s_last = surface_amp_loop(torch, np_ids, np_labels,
                                                surface=True)
    routes = {k.name: {r: n - before[k.name][r]
                       for r, n in k.route_launches.items()}
              for k in ck.KERNELS}
    import paddle_tpu_torch as paddle
    with paddle.no_grad():
        _, loss = s_model(paddle.to_tensor(np_ids[:1, :128]),
                          labels=paddle.to_tensor(np_labels[:1, :128]))
    if not isinstance(loss, paddle.Tensor):
        raise AssertionError(f"the model fed paddle Tensors returned a "
                             f"{type(loss)} loss, not a paddle Tensor")
    t_model, t_steps, t_last = surface_amp_loop(torch, np_ids, np_labels,
                                                surface=False)
    s_losses, t_losses = [r[0] for r in s_steps], [r[0] for r in t_steps]
    s_scales = [r[1] for r in s_steps] + [s_last]
    t_scales = [r[1] for r in t_steps] + [t_last]
    s_secs, t_secs = [r[-1] for r in s_steps], [r[-1] for r in t_steps]
    layers = s_model.config.num_layers
    steps = SURFACE_WARMUP + SURFACE_TIMED
    tokens = np_ids.size
    differing = [n for (n, a), b in zip(s_model.named_parameters(),
                                        t_model.parameters())
                 if not torch.equal(a, b)]
    del s_model, t_model
    torch.cuda.empty_cache()
    flash = {"causal": surface_flash_grad(torch, True),
             "non_causal": surface_flash_grad(torch, False)}
    t0 = time.perf_counter()
    sweep_report, sweep_failures = sweep.device_sweep("gpu")
    random_report, random_failures = sweep.random_checks("gpu")
    sweep_s = time.perf_counter() - t0
    out = {"phase": "paddle_surface", "nvidia_smi": smi,
           "model": "gpt_small (GPT-124M) at 16 x 1024, the eager fp16 "
                    "AMP recipe of gpt124m_fp16_amp, fed paddle Tensors "
                    "and torch tensors",
           "steps": steps, "timed_steps": SURFACE_TIMED,
           "tokens_per_s_surface": tokens * SURFACE_TIMED
           / sum(s_secs[SURFACE_WARMUP:]),
           "tokens_per_s_torch": tokens * SURFACE_TIMED
           / sum(t_secs[SURFACE_WARMUP:]),
           "step_ms_surface": [s * 1e3 for s in s_secs],
           "step_ms_torch": [s * 1e3 for s in t_secs],
           "losses_surface": s_losses, "losses_torch": t_losses,
           "scales": s_scales, "launches_by_route": routes,
           "params_differing": differing,
           "flash_grad_bit_equal": flash,
           "sweep_ops": sum(r["ops"] for r in sweep_report.values()),
           "sweep_worst_by_family": sweep_report,
           "sweep_failures": sweep_failures,
           "random_ops": random_report,
           "random_failures": random_failures,
           "sweep_seconds": sweep_s}
    emit(out)
    if s_losses != t_losses or s_scales != t_scales or differing:
        raise AssertionError(
            f"the surface loop is not bit-equal to the torch-fed one: "
            f"losses {s_losses} vs {t_losses}, scales {s_scales} vs "
            f"{t_scales}, parameters differing {differing[:5]}")
    want = layers * steps
    for name in ("flash_fwd", "flash_bwd"):
        if routes[name] != {"fp32": 0, "bf16": 0, "fp16": want}:
            raise AssertionError(f"the surface loop's {steps} steps of "
                                 f"{layers} layers launched {name} "
                                 f"{routes[name]}; want {want} on fp16")
    if sweep_failures or random_failures:
        raise AssertionError(f"the op sweep failed on the card: "
                             f"{sweep_failures} {random_failures}")


def gpt124m_scheduled(torch, seed=0, check_nan=True):
    """GPT-124M through ``CompiledTrainStep`` at O2 bf16 with
    ``examples/train_gpt.py``'s surface at bench.py's widths: AdamW under
    ``CosineAnnealingDecay(3e-4, 14)`` with ``ClipGradByGlobalNorm(1.0)``,
    ``FLAGS_check_nan_inf`` set before the step is built (it is read
    then; ``check_nan=False`` leaves it as it is) and
    ``set_meter_info(tokens_per_step=16384)``, weights from ``seed``.
    Returns (model, opt, sched, step, batch) with ``batch`` as
    ``gpt124m_training``'s; ``scripts/profile_torch_train_step.py`` traces
    this same workload."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    if check_nan:
        set_flags({"FLAGS_check_nan_inf": True})
    cfg = gpt_small()
    model = GPTForPretraining(cfg, device="cuda", seed=seed)
    sched = popt.lr.CosineAnnealingDecay(3e-4, TRAIN_WARMUP + TRAIN_TIMED + 1)
    opt = popt.AdamW(learning_rate=sched, parameters=model.parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        lambda i, lb: model(i, labels=lb)[1], model, opt,
        amp_level="O2").set_meter_info(
            tokens_per_step=TRAIN_BATCH * cfg.max_seq_len)
    shape = (TRAIN_BATCH, cfg.max_seq_len)
    return model, opt, sched, step, _token_batches(
        torch, cfg.vocab_size, shape, shape, cfg.vocab_size)


def phase_gpt124m_scheduled(torch, ck, smi):
    """``gpt124m_scheduled``'s workload with the StepMeter on: 3 warm-up
    and 10 timed calls with the nan check on, the scheduler stepped after
    each, then a ``run_steps`` block of 8 at the rate of the block's
    start, through a step built with the flag clear (``run_steps``
    refuses the flag, as the reference does, and the flagged step must
    raise so). The rate each step read must be the scheduler's sequence,
    and the meter must count each call and the block. Then one
    ``use_rmsnorm=True`` step at full width."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.observability import metrics, perf
    from paddle_tpu_torch.text.gpt import GPTForPretraining, gpt_small
    n_calls = TRAIN_WARMUP + TRAIN_TIMED
    try:
        model, opt, sched, step, batch = gpt124m_scheduled(torch)
        read = []
        get_lr = opt.get_lr
        opt.get_lr = lambda: read.append(get_lr()) or read[-1]
        ids, labels = batch()
        ids_k, labels_k = batch(TRAIN_K)
        try:
            step.run_steps(ids_k, labels_k)
        except RuntimeError as e:
            if "FLAGS_check_nan_inf" not in str(e):
                raise
        else:
            raise AssertionError("run_steps took FLAGS_check_nan_inf")
        set_flags({"FLAGS_check_nan_inf": False})
        block_step = CompiledTrainStep(
            step.fn, model, opt, amp_level="O2").set_meter_info(
                tokens_per_step=step.meter_tokens)
        steps_total = metrics.counter("perf_steps_total")
        gauge = metrics.gauge("perf_tokens_per_sec")
        n0 = steps_total.total()
        perf.enable()
        losses, host_s, meter_tps = [], [], []
        for i in range(n_calls):
            t0 = time.perf_counter()
            losses.append(step(ids, labels).item())
            host_s.append(time.perf_counter() - t0)
            meter_tps.append(gauge.series()[()])
            sched.step()
        t0 = time.perf_counter()
        block = block_step.run_steps(ids_k, labels_k)
        block_host_s = time.perf_counter() - t0
        block_meter_tps = gauge.series()[()]
        perf.disable()
        metered = steps_total.total() - n0
        losses += block.tolist()
        fresh = popt.lr.CosineAnnealingDecay(3e-4, n_calls + 1)
        want = []
        for _ in range(n_calls + 1):
            want.append(fresh())
            fresh.step()
        timed = slice(TRAIN_WARMUP, None)
        tokens = ids.numel()
        out = {"phase": "gpt124m_scheduled", "nvidia_smi": smi,
               "model": "gpt_small (GPT-124M), CompiledTrainStep O2 bf16, "
                        "AdamW under CosineAnnealingDecay(3e-4, 14), "
                        "ClipGradByGlobalNorm(1.0), FLAGS_check_nan_inf per "
                        "call (run_steps refuses it), "
                        "StepMeter on, random weights seed 0",
               "lr_read": read, "lr_scheduler": want,
               "losses": losses,
               "metered_steps": metered,
               "per_call_tokens_per_s_host":
                   tokens * TRAIN_TIMED / sum(host_s[timed]),
               "per_call_tokens_per_s_meter":
                   sum(meter_tps[timed]) / TRAIN_TIMED,
               "per_call_tokens_per_s_meter_each": meter_tps,
               "run_steps_tokens_per_s_host":
                   tokens * TRAIN_K / block_host_s,
               "run_steps_tokens_per_s_meter": block_meter_tps}
        # one RMSNorm step at full width
        rms = GPTForPretraining(gpt_small(use_rmsnorm=True), device="cuda",
                                seed=0)
        ropt = popt.AdamW(learning_rate=1e-4, parameters=rms.parameters())
        rstep = CompiledTrainStep(lambda i, lb: rms(i, labels=lb)[1], rms,
                                  ropt, amp_level="O2")
        out["rmsnorm_loss"] = rstep(ids, labels).item()
        emit(out)
    finally:
        perf.disable()
        set_flags({"FLAGS_check_nan_inf": False})
    if read != want:
        raise AssertionError(f"the steps read {read}; the scheduler's "
                             f"sequence is {want}")
    if metered != n_calls + 1:
        raise AssertionError(f"the StepMeter counted {metered} steps of "
                             f"{n_calls} calls and one block")
    if not all(math.isfinite(x) for x in losses + [out["rmsnorm_loss"]]):
        raise AssertionError(f"a loss is not finite: {losses}, "
                             f"{out['rmsnorm_loss']}")


def eager_exactness_fp32(torch, ck, phase, describe, cfg, ids, labels):
    """Two eager O0 steps of the upstream recipe (warm-up/cosine schedule,
    global-norm clip, an enabled ``GradScaler``: outside an fp16
    ``auto_cast`` block the ambient dtype is float32, so it scales) of a
    full-width, 2-layer fp32 GPT from one seed, on the card and on the
    CPU: both losses within 1e-4, the first step's unscaled gradients
    within 1e-4 of their largest entry (one that is zero up to rounding
    below 1e-6 of the largest gradient on both), and the scales, skips and
    rates equal."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.text.gpt import GPTForPretraining
    res = {}
    for dev in ("cuda", "cpu"):
        model = GPTForPretraining(cfg, device=dev, seed=0)
        sched = popt.lr.LinearWarmup(popt.lr.CosineAnnealingDecay(1e-4, 1000),
                                     2, 1e-5, 1e-4)
        opt = popt.AdamW(learning_rate=sched, parameters=model.parameters(),
                         grad_clip=ClipGradByGlobalNorm(1.0))
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
        grads = {}
        clear = opt.clear_grad

        def keep_then_clear():
            if not grads:
                grads.update({n: p.grad.detach().cpu()
                              for n, p in model.named_parameters()})
            clear()
        opt.clear_grad = keep_then_clear
        steps = eager_amp_steps(torch, model, ids.to(dev), labels.to(dev), 2,
                                "O0", "float32", sched, scaler, opt,
                                sync=dev == "cuda")
        res[dev] = ([s[:4] for s in steps], grads)
    (card, cg), (cpu, pg) = res["cuda"], res["cpu"]
    top = max(float(g.abs().max()) for g in pg.values())
    zero = sorted(n for n, g in pg.items()
                  if float(g.abs().max()) <= 1e-6 * top)
    rel = {n: max_err(g, pg[n]) / float(pg[n].abs().max())
           for n, g in cg.items() if n not in zero}
    worst = max(rel, key=rel.get)
    loss_err = max(abs(a[0] - b[0]) for a, b in zip(card, cpu))
    out = {"phase": phase, "tf32": False, "model": describe,
           "batch": list(ids.shape), "losses_cuda": [s[0] for s in card],
           "losses_cpu": [s[0] for s in cpu], "loss_abs_err": loss_err,
           "loss_tol": 1e-4, "grad_max_rel_err": rel[worst],
           "grad_worst": worst, "grad_rel_tol": 1e-4,
           "grads_zero_up_to_rounding": zero,
           "scale_skip_lr_cuda": [s[1:] for s in card],
           "scale_skip_lr_cpu": [s[1:] for s in cpu]}
    emit(out)
    zero_ok = all(float(cg[n].abs().max()) <= 1e-6 * top for n in zero)
    if loss_err > 1e-4 or rel[worst] > 1e-4 or not zero_ok or \
            [s[1:] for s in card] != [s[1:] for s in cpu]:
        raise AssertionError(f"{phase}: card differs from the CPU: loss "
                             f"{loss_err}, {worst} {rel[worst]}")


def phase_eager_exactness_fp32(torch, ck):
    """The eager recipe at O0 in fp32, GPT-124M's widths, 2 layers, batch
    2 x 1024, with LayerNorm and with RMSNorm."""
    from paddle_tpu_torch.text.gpt import GPTConfig
    for rms in (False, True):
        cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12,
                        use_rmsnorm=rms)
        ids, labels = _seeded_ids(torch, cfg.vocab_size,
                                  (2, cfg.max_seq_len))
        eager_exactness_fp32(
            torch, ck, "eager_rmsnorm_exactness_fp32" if rms
            else "eager_exactness_fp32",
            f"GPT-124M widths, 2 layers, {'RMSNorm' if rms else 'LayerNorm'}"
            ", fp32, eager O0, warm-up/cosine, clip, GradScaler(2**15), "
            "batch 2 x 1024", cfg, ids, labels)


def _one_eager_step(torch, cfg, ids, labels, level, dtype, scale=2.0 ** 15):
    """Loss and gradients (fp32, on the CPU) of one eager step of a
    2-layer GPT from seed 0 on the card: fp32 parameters at O0, or
    ``decorate``d to ``dtype`` at O2. The loss is scaled by ``scale``
    (a power of two) before the backward and the gradients unscaled in
    fp32 after, as ``GradScaler`` does: unscaled, fp16 gradients of the
    logits (about 1/(vocab x tokens)) fall below fp16's range."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.gpt import GPTForPretraining
    model = GPTForPretraining(cfg, device="cuda", seed=0)
    if level == "O2":
        model = amp.decorate(model, level="O2", dtype=dtype)
    with amp.auto_cast(enable=level == "O2", level=level, dtype=dtype):
        _, loss = model(ids, labels=labels)
    (loss * scale).backward()
    return loss.item(), {n: p.grad.float().cpu() / scale
                         for n, p in model.named_parameters()}


def phase_fp16_against_fp32(torch, ck):
    """One eager O2 fp16 step of GPT-124M's widths at 2 layers (batch 2 x
    1024), its loss scaled by 2^15 as the recipe's scaler does, against
    the same step in fp32 O0 on the card. The bound, from
    fp16's unit roundoff u = 2^-11: the loss within 8u of its value (a
    handful of roundings a layer of activations whose error the layer
    norms do not grow; the loss is 1-Lipschitz in the logits' max-norm),
    and every gradient's error against fp32, relative to its largest
    entry, at most half the worst one the same step shows in bf16 O2
    (fp16 keeps 3 more significant bits, so about an eighth is expected;
    gradients zero up to rounding in fp32, below 1e-6 of the largest, are
    left out)."""
    from paddle_tpu_torch.text.gpt import GPTConfig
    cfg = GPTConfig(hidden_size=768, num_layers=2, num_heads=12)
    ids, labels = (t.to("cuda") for t in _seeded_ids(
        torch, cfg.vocab_size, (2, cfg.max_seq_len)))
    ref_loss, ref = _one_eager_step(torch, cfg, ids, labels, "O0",
                                    "float32")
    top = max(float(g.abs().max()) for g in ref.values())
    keep = [n for n, g in ref.items() if float(g.abs().max()) > 1e-6 * top]
    errs = {}
    for dtype in ("float16", "bfloat16"):
        loss, grads = _one_eager_step(torch, cfg, ids, labels, "O2", dtype)
        rel = {n: max_err(grads[n], ref[n]) / float(ref[n].abs().max())
               for n in keep}
        worst = max(rel, key=rel.get)
        errs[dtype] = (abs(loss - ref_loss), rel[worst], worst)
    loss_tol = 8 * 2.0 ** -11 * abs(ref_loss)
    grad_tol = 0.5 * errs["bfloat16"][1]
    out = {"phase": "fp16_against_fp32", "model": "GPT-124M widths, 2 "
           "layers, batch 2 x 1024, one eager step: decorate + auto_cast O2 "
           "against fp32 O0 on the card", "loss_fp32": ref_loss,
           "fp16_loss_abs_err": errs["float16"][0], "loss_tol": loss_tol,
           "fp16_grad_max_rel_err": errs["float16"][1],
           "fp16_grad_worst": errs["float16"][2],
           "bf16_loss_abs_err": errs["bfloat16"][0],
           "bf16_grad_max_rel_err": errs["bfloat16"][1],
           "grad_rel_tol": grad_tol}
    emit(out)
    if errs["float16"][0] > loss_tol or errs["float16"][1] > grad_tol:
        raise AssertionError(f"fp16 O2 step off fp32: {out}")


# -- phase 6 ------------------------------------------------------------------
def packed_attention(torch, dtype):
    """The packed-attention workload: ``packed_lengths()`` documents, 12
    heads of 64, causal, with cu_k is cu_q. Returns (lens, q, k, v, do,
    cu) with q, k, v requiring gradients."""
    lens = packed_lengths()
    q, k, v, do, cu, _ = varlen_case(torch, lens, None, PACKED_HEADS,
                                     PACKED_DIM, dtype)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    return lens, q, k, v, do, cu


def phase_packed_attention_bf16(torch, ck, smi):
    """``F.flash_attn_unpadded`` at full width: 3 warm-up forward +
    backward calls, 10 timed forwards, then 10 timed forward + backward
    calls (``torch.autograd.grad`` for dq, dk, dv against a seeded do)."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    lens, q, k, v, do, cu = packed_attention(torch, torch.bfloat16)
    longest = max(lens)

    def forward():
        return flash_attn_unpadded(q, k, v, cu, cu, longest, longest,
                                   causal=True)[0]

    def step():
        out = forward()
        return out, torch.autograd.grad(out, (q, k, v), do)

    torch.cuda.reset_peak_memory_stats()
    before = {k_.name: k_.launches for k_ in ck.KERNELS}
    for _ in range(PACKED_WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PACKED_TIMED):
        forward()
    torch.cuda.synchronize()
    fwd_s = (time.perf_counter() - t0) / PACKED_TIMED
    t0 = time.perf_counter()
    for _ in range(PACKED_TIMED):
        out, grads = step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / PACKED_TIMED
    launches = {k_.name: k_.launches - before[k_.name] for k_ in ck.KERNELS}
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    pairs = visible_pairs(lens, lens, True)
    out_ = {"phase": "packed_attention_bf16", "nvidia_smi": smi,
            "workload": "flash_attn_unpadded, causal, bf16, 12 heads of 64, "
                        "random inputs seed 0",
            "tokens": PACKED_TOKENS, "segments": len(lens),
            "lengths": lens, "visible_pairs_per_head": pairs,
            "visible_pairs": pairs * PACKED_HEADS,
            "forward_ms": fwd_s * 1e3, "forward_backward_ms": step_s * 1e3,
            "forward_backward_tokens_per_s": PACKED_TOKENS / step_s,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "finite": finite,
            "out_shape": list(out.shape)}
    emit(out_)
    want_fwd = PACKED_WARMUP + 2 * PACKED_TIMED
    want_bwd = PACKED_WARMUP + PACKED_TIMED
    if launches["flash_varlen_fwd"] != want_fwd or \
            launches["flash_varlen_bwd"] != want_bwd:
        raise AssertionError(
            f"{want_fwd} forwards and {want_bwd} backwards launched K4 "
            f"{launches['flash_varlen_fwd']} and K5 "
            f"{launches['flash_varlen_bwd']} times")
    if not finite or list(out.shape) != [PACKED_TOKENS, PACKED_HEADS,
                                         PACKED_DIM]:
        raise AssertionError("packed attention output or a gradient is not "
                             "finite, or the output is mis-shaped")


def phase_packed_attention_exactness_fp32(torch, ck):
    """The same workload in fp32 (TF32 off): ``flash_attn_unpadded``'s o,
    dq, dk and dv on the card against the per-segment plain versions,
    each within 1e-4 of its largest entry."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    lens, q, k, v, do, cu = packed_attention(torch, torch.float32)
    before = {k_.name: k_.launches for k_ in ck.KERNELS}
    out = flash_attn_unpadded(q, k, v, cu, cu, max(lens), max(lens),
                              causal=True)[0]
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    launches = {k_.name: k_.launches - before[k_.name] for k_ in ck.KERNELS}
    out, q, k, v = out.detach(), q.detach(), k.detach(), v.detach()
    ro, rlse = ck.flash_attention_varlen_reference(q, k, v, cu, cu, True)
    ref = ck.flash_attention_varlen_bwd_reference(q, k, v, ro, rlse, do, cu,
                                                  cu, True)
    rel = {name: max_err(a, r) / max(float(r.abs().max()), 1e-30)
           for name, a, r in zip(("o", "dq", "dk", "dv"), (out, *grads),
                                 (ro, *ref))}
    out_ = {"phase": "packed_attention_exactness_fp32", "tf32": False,
            "workload": "packed_attention_bf16's lengths and inputs in fp32",
            "max_rel_err": rel, "rel_tol": 1e-4, "launches": launches}
    emit(out_)
    if launches["flash_varlen_fwd"] != 1 or launches["flash_varlen_bwd"] != 1:
        raise AssertionError(f"one forward and backward launched {launches}")
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"packed attention on the card differs from the "
                             f"plain versions: {rel}")


# -- phase 7 ------------------------------------------------------------------
# the vision path: ResNet-50 ImageNet training at batch 256 of 224 x 224
# (benchmarks/matrix.py:71-92) and LeNet at batch 256 of 28 x 28
# (matrix.py:49-68), each with its run_steps K; no hand-written kernel is
# on it (cuDNN convolutions and batch norms, ATen pools)
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES, RESNET_K = 256, 224, 1000, 8
RESNET_EXACT_BATCH = 2
LENET_BATCH, LENET_K = 256, 32


def _image_batches(torch, shape, classes, device="cuda"):
    """``batch(*lead)`` drawing fp32 images uniform in [0, 1) of shape
    lead + ``shape`` and int64 labels in [0, ``classes``) of shape lead +
    shape[:1], from one ``numpy.random.default_rng(0)``, as
    ``benchmarks/matrix.py`` draws them; on ``device``, or as numpy arrays
    with ``device=None``."""
    import numpy as np
    rng = np.random.default_rng(0)

    def batch(*lead):
        x = rng.uniform(0, 1, lead + shape).astype(np.float32)
        y = rng.integers(0, classes, lead + shape[:1]).astype(np.int64)
        if device is None:
            return x, y
        return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    return batch


def resnet50_training(torch, data_format="NCHW"):
    """ResNet-50 ImageNet training as ``benchmarks/matrix.py:71-92`` runs
    it: ``resnet50(num_classes=1000)`` with fp32 parameters from seed 0,
    ``Momentum(learning_rate=0.1, momentum=0.9)``, ``nn.CrossEntropyLoss``,
    a bf16 O2 ``CompiledTrainStep`` over ``lambda x, y: loss_fn(net(x),
    y)``. Returns (model, step, batch); ``batch(*lead)`` draws images of
    shape lead + (256, 3, 224, 224) and labels on the card.
    ``scripts/profile_torch_train_step.py --workload resnet50`` traces
    this same workload."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(num_classes=RESNET_CLASSES, data_format=data_format,
                     device="cuda", seed=0)
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters())
    loss_fn = CrossEntropyLoss()
    step = CompiledTrainStep(lambda x, y: loss_fn(model(x), y), model, opt,
                             amp_level="O2")
    return model, step, _image_batches(
        torch, (RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE), RESNET_CLASSES)


def flops_per_image(torch, model, shape):
    """Training FLOPs of one image: 3 x the forward's multiply-adds x 2,
    counted from every convolution's and linear layer's shapes on one
    ``shape`` image (the batch norms, pools and adds, under 1%, are left
    out, as MFU counts are)."""
    from paddle_tpu_torch.nn import Conv2D, Linear
    counted = []

    def conv(m, inp, out):
        counted.append(2 * out.numel() * m.weight[0].numel())

    def linear(m, inp, out):
        counted.append(2 * out.numel() * m.weight.shape[0])

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv2D)
                                     else linear)
             for m in model.modules() if isinstance(m, (Conv2D, Linear))]
    was = model.training
    model.eval()
    with torch.no_grad():
        model(torch.zeros((1,) + shape, device="cuda"))
    model.train(was)
    for h in hooks:
        h.remove()
    return 3 * sum(counted)


def _rates(images, step_s, per_image):
    ips = images / step_s
    return {"step_ms": step_s * 1e3, "images_per_s": ips,
            "mfu": ips * per_image / PEAK_BF16_FLOPS}


def _timed_steps(torch, step, x, y, warmup, timed):
    """Losses of ``warmup`` then ``timed`` calls, and the mean seconds of
    the timed ones (host clock, synchronized at both ends)."""
    losses = [step(x, y) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(timed)]
    torch.cuda.synchronize()
    return [float(v) for v in losses], (time.perf_counter() - t0) / timed


def phase_resnet50_training_bf16(torch, smi):
    """ResNet-50 at batch 256 x 3 x 224 x 224, O2: 3 warm-up and 10 timed
    calls, then one timed ``run_steps`` block of K = 8 (the number
    ``matrix.py`` reports); the same per call channels-last (NHWC), as
    information. Returns the K block (images, labels) on the card and its
    numpy copy for the ``Model.fit`` phase."""
    model, step, _ = resnet50_training(torch)
    shape = (3, RESNET_SIZE, RESNET_SIZE)
    per_image = flops_per_image(torch, model, shape)
    # matrix.py's draw: the K block first; the per-call batch is its first
    block_np = _image_batches(torch, (RESNET_BATCH,) + shape, RESNET_CLASSES,
                              device=None)(RESNET_K)
    xk, yk = (torch.from_numpy(a).cuda() for a in block_np)
    x, y = xk[0], yk[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, per_call_s = _timed_steps(torch, step, x, y, TRAIN_WARMUP,
                                      TRAIN_TIMED)
    t0 = time.perf_counter()
    block = step.run_steps(xk, yk)
    torch.cuda.synchronize()
    run_steps_s = (time.perf_counter() - t0) / RESNET_K
    peak = torch.cuda.max_memory_allocated()
    losses += block.tolist()
    del model, step
    torch.cuda.empty_cache()
    _, nhwc_step, _ = resnet50_training(torch, "NHWC")
    _, nhwc_s = _timed_steps(torch, nhwc_step, x, y, TRAIN_WARMUP,
                             TRAIN_TIMED)
    del nhwc_step
    torch.cuda.empty_cache()
    emit({"phase": "resnet50_training_bf16", "nvidia_smi": smi,
          "model": "resnet50(num_classes=1000), fp32 params, O2 bf16 "
                   "compute, Momentum lr 0.1 momentum 0.9, random weights "
                   "seed 0, uniform images and labels seed 0, NCHW",
          "batch": RESNET_BATCH, "image": list(shape),
          "flops_per_image": per_image, "mfu_peak_flops": PEAK_BF16_FLOPS,
          "per_call": _rates(RESNET_BATCH, per_call_s, per_image),
          f"run_steps_k{RESNET_K}": _rates(RESNET_BATCH, run_steps_s,
                                           per_image),
          "nhwc_per_call": _rates(RESNET_BATCH, nhwc_s, per_image),
          "peak_memory_bytes": peak, "losses": losses})
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a ResNet-50 loss is not finite: {losses}")
    return xk, yk, block_np


def fit_recorder(torch):
    """A ``Model.fit`` callback keeping every step's loss and each epoch's
    seconds (host clock, synchronized at both ends)."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Recorder(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.epoch_s = [], []

        def on_epoch_begin(self, epoch, logs=None):
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))

        def on_epoch_end(self, epoch, logs=None):
            torch.cuda.synchronize()
            self.epoch_s.append(time.perf_counter() - self._t0)

    return Recorder()


def phase_resnet50_fit_bf16(torch, smi, xk, yk, block_np):
    """ResNet-50 through ``paddle.Model``, the entry point
    ``BASELINE.json`` names: ``prepare(Momentum, CrossEntropyLoss,
    amp_configs="O2")``, then ``fit`` over the K block's 8 x 256 images
    (numpy, on the host: the loader's batches are copied to the card, a
    block of 8 at a time), 2 epochs, ``steps_per_execution=8``; then
    ``evaluate`` with ``Accuracy`` on the first two batches. cuDNN is
    deterministic in this phase, and fit's 16 losses are held to the same
    steps through ``run_steps`` on the card-resident block from the same
    weights within rtol 2e-2 (bf16 losses: a few ulps)."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    torch.backends.cudnn.deterministic = True
    try:
        images = block_np[0].reshape((-1,) + block_np[0].shape[2:])
        labels = block_np[1].reshape(-1)
        net = resnet50(num_classes=RESNET_CLASSES, device="cuda", seed=0)
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=net.parameters())
        model = Model(net).prepare(opt, CrossEntropyLoss(),
                                   amp_configs="O2")
        rec = fit_recorder(torch)
        torch.cuda.reset_peak_memory_stats()
        model.fit(TensorDataset([images, labels]), batch_size=RESNET_BATCH,
                  epochs=2, shuffle=False, steps_per_execution=RESNET_K,
                  verbose=0, callbacks=[rec])
        peak = torch.cuda.max_memory_allocated()
        model.prepare(opt, CrossEntropyLoss(), metrics=Accuracy(),
                      amp_configs="O2")
        two = 2 * RESNET_BATCH
        evaluated = model.evaluate(
            TensorDataset([images[:two], labels[:two]]),
            batch_size=RESNET_BATCH, verbose=0)
        del net, opt, model
        torch.cuda.empty_cache()
        _, step, _ = resnet50_training(torch)
        direct = step.run_steps(xk, yk).tolist() + \
            step.run_steps(xk, yk).tolist()
        del step
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    rel = [abs(a - b) / abs(b) for a, b in zip(rec.losses, direct)]
    epoch_s = rec.epoch_s[1]
    images_per_s = RESNET_K * RESNET_BATCH / epoch_s
    emit({"phase": "resnet50_fit_bf16", "nvidia_smi": smi,
          "entry": "Model(resnet50).prepare(Momentum(0.1, 0.9), "
                   "CrossEntropyLoss(), amp_configs='O2').fit("
                   "TensorDataset([8 x 256 images, labels]), batch_size=256, "
                   "epochs=2, shuffle=False, steps_per_execution=8)",
          "cudnn_deterministic": True,
          "epoch_s": rec.epoch_s,
          "images_per_s_epoch2": images_per_s,
          "step_ms_epoch2": epoch_s / RESNET_K * 1e3,
          "peak_memory_bytes": peak, "fit_losses": rec.losses,
          "run_steps_losses": direct, "max_rel_diff": max(rel),
          "bit_equal_steps": sum(a == b for a, b in zip(rec.losses, direct)),
          "rel_tol": 2e-2, "evaluate": evaluated})
    if len(rec.losses) != 2 * RESNET_K or max(rel) > 2e-2:
        raise AssertionError(f"fit's losses {rec.losses} differ from "
                             f"run_steps' {direct}")
    if not (math.isfinite(evaluated["loss"]) and
            0.0 <= evaluated["acc"] <= 1.0):
        raise AssertionError(f"evaluate gave {evaluated}")


def phase_resnet50_exactness_fp32(torch, ck):
    """Full-depth ResNet-50 (1000 classes) at 2 x 3 x 224 x 224, built
    from seed 0 on the card and on the CPU in fp32 (TF32 off), and on the
    CPU in fp64 as the arbiter: one training forward and backward, then,
    every model given the fp64 model's running statistics, an eval
    forward and backward. Held, card against CPU: the loss within 1e-4,
    both running statistics after the step within 1e-4 of each one's
    largest entry, the eval logits within 1e-4 of their largest entry.
    The gradients are held to fp64: fp32 does not determine them to 1e-4
    of the largest entry here (at random initialization the backward
    through the batch norms' statistics, and in eval mode through
    statistics that one step has barely moved, amplifies each rounding;
    on the CPU, fp32 against fp64: 1.3e-2 of the largest training-mode
    gradient, 8.7e-4 of the largest eval-mode one). So the card's worst
    gradient error against fp64, as a share of the largest fp64 entry,
    must stay within twice the CPU's fp32 error in eval mode and within
    four times in training mode, where the card's cuDNN and ATen kernels
    sum in other orders and the batch statistics amplify each
    difference."""
    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.vision.models import resnet50
    x, y = _image_batches(torch, (RESNET_EXACT_BATCH, 3, RESNET_SIZE,
                                  RESNET_SIZE), RESNET_CLASSES,
                          device=None)()
    loss_fn = CrossEntropyLoss()
    before = {k.name: k.launches for k in ck.KERNELS}
    runs = (("cuda", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
            ("fp64", "cpu", torch.float64))
    models, out = {}, {}
    for name, dev, dt in runs:
        m = models[name] = resnet50(num_classes=RESNET_CLASSES, device=dev,
                                    seed=0).to(dt)
        xd, yd = torch.from_numpy(x).to(dev, dt), torch.from_numpy(y).to(dev)
        loss = loss_fn(m(xd), yd)
        loss.backward()
        out[name] = {"loss": loss.item(), "train_grads": _grads(m),
                     "stats": {n: b.cpu() for n, b in m.named_buffers()}}
    # eval mode, every model on the fp64 model's statistics: one function
    stats = {n: b.numpy() for n, b in out["fp64"]["stats"].items()}
    for name, dev, dt in runs:
        m = models[name]
        load_jax_state(m, stats | {n: p.detach().cpu().numpy()
                                   for n, p in m.named_parameters()})
        m.eval()
        m.zero_grad(set_to_none=True)
        xd, yd = torch.from_numpy(x).to(dev, dt), torch.from_numpy(y).to(dev)
        logits = m(xd)
        loss_fn(logits, yd).backward()
        out[name].update(logits=logits.detach().cpu(), grads=_grads(m))
    torch.cuda.synchronize()
    launches = {k.name: k.launches - before[k.name] for k in ck.KERNELS}
    card, cpu, ref = out["cuda"], out["cpu"], out["fp64"]
    loss_err = abs(card["loss"] - cpu["loss"])
    stats_rel = max(max_err(card["stats"][n], s) / float(s.abs().max())
                    for n, s in cpu["stats"].items())
    logits_rel = max_err(card["logits"], cpu["logits"]) / \
        float(cpu["logits"].abs().max())

    def against_fp64(key):
        """(worst error of the card's, of the CPU's fp32 gradients
        against fp64, each as a share of the largest fp64 entry; the
        card's worst tensor)."""
        top = max(float(g.abs().max()) for g in ref[key].values())
        errs = {dev: {n: float((g.double() - ref[key][n]).abs().max())
                      for n, g in out[dev][key].items()}
                for dev in ("cuda", "cpu")}
        worst = max(errs["cuda"], key=errs["cuda"].get)
        return (errs["cuda"][worst] / top,
                max(errs["cpu"].values()) / top, worst)

    held = {"eval_grads": (against_fp64("grads"), 2.0),
            "train_grads": (against_fp64("train_grads"), 4.0)}
    emit({"phase": "resnet50_exactness_fp32", "tf32": False,
          "model": "resnet50(num_classes=1000), seed 0, batch 2 x 3 x 224 x "
                   "224; fp32 on the card and the CPU, fp64 on the CPU",
          "loss_cuda": card["loss"], "loss_cpu": cpu["loss"],
          "loss_fp64": ref["loss"], "loss_abs_err": loss_err,
          "loss_tol": 1e-4, "running_stats_max_rel_err": stats_rel,
          "eval_logits_max_rel_err": logits_rel, "rel_tol": 1e-4,
          **{f"{key}_vs_fp64_of_largest": {
              "cuda": c, "cpu_fp32": p, "cuda_worst": w,
              "tol_times_cpu": k}
             for key, ((c, p, w), k) in held.items()},
          "params": len(card["grads"]), "launches": launches})
    if any(launches.values()):
        raise AssertionError(f"the ResNet-50 step launched {launches}")
    if loss_err > 1e-4 or stats_rel > 1e-4 or logits_rel > 1e-4:
        raise AssertionError(
            f"the card's ResNet-50 differs from the CPU's: loss {loss_err}, "
            f"running statistics {stats_rel}, eval logits {logits_rel}")
    for key, ((c, p, w), k) in held.items():
        if c > k * p:
            raise AssertionError(
                f"{key}: the card's {w} is {c} of the largest fp64 entry "
                f"away, more than {k} x the CPU's fp32 {p}")


def phase_lenet_fit(torch, smi):
    """LeNet through ``Model.fit`` as ``matrix.py:49-68`` sizes it: Adam at
    lr 1e-3, batch 256 x 1 x 28 x 28, K = 32 batches a block
    (``steps_per_execution``), O0; 2 epochs over 32 batches, the second
    timed."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet
    images, labels = _image_batches(torch, (LENET_BATCH * LENET_K, 1, 28, 28),
                                    10, device=None)()
    net = LeNet(num_classes=10, device="cuda", seed=0)
    model = Model(net).prepare(Adam(learning_rate=1e-3,
                                    parameters=net.parameters()),
                               CrossEntropyLoss())
    rec = fit_recorder(torch)
    model.fit(TensorDataset([images, labels]), batch_size=LENET_BATCH,
              epochs=2, shuffle=False, steps_per_execution=LENET_K,
              verbose=0, callbacks=[rec])
    epoch_s = rec.epoch_s[1]
    emit({"phase": "lenet_fit", "nvidia_smi": smi,
          "entry": "Model(LeNet()).prepare(Adam(1e-3), CrossEntropyLoss())"
                   ".fit(batch_size=256, epochs=2, steps_per_execution=32)",
          "epoch_s": rec.epoch_s,
          "images_per_s_epoch2": LENET_K * LENET_BATCH / epoch_s,
          "step_ms_epoch2": epoch_s / LENET_K * 1e3,
          "first_and_last_loss": [rec.losses[0], rec.losses[-1]]})
    if len(rec.losses) != 2 * LENET_K or \
            not all(math.isfinite(v) for v in rec.losses):
        raise AssertionError(f"LeNet's fit gave {rec.losses}")


def phase_vision(torch, ck, smi):
    """The vision path's phases, in order."""
    xk, yk, block_np = phase_resnet50_training_bf16(torch, smi)
    phase_resnet50_fit_bf16(torch, smi, xk, yk, block_np)
    del xk, yk, block_np
    torch.cuda.empty_cache()
    phase_resnet50_exactness_fp32(torch, ck)
    phase_lenet_fit(torch, smi)


# -- phase 8 ------------------------------------------------------------------
# -- the checkpoint_resume path -----------------------------------------------
CKPT_STEPS, CKPT_SPLIT = 8, 4


def _route_counts(ck):
    return {k.name: dict(k.route_launches) for k in ck.KERNELS}


def _launch_delta(ck, before, name, route):
    k = next(k for k in ck.KERNELS if k.name == name)
    return k.route_launches[route] - before[name][route]


def _gpt_state(model, opt):
    """Copies of every parameter and every optimizer accumulator, by
    name, on the card."""
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    accs = {f"{n}.{a}": v.detach().clone()
            for n, p in model.named_parameters()
            for a, v in opt._accumulators.get(id(p), {}).items()}
    return params, accs


def _state_diff(torch, got, want):
    """The largest absolute difference between two ``_gpt_state``s (inf
    when their names or dtypes differ)."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.keys() != b.keys():
            return math.inf
        for k in a:
            if a[k].dtype != b[k].dtype:
                return math.inf
            worst = max(worst, (a[k].double() - b[k].double()).abs()
                        .max().item())
    return worst


def _gpt_run(torch, ck, step, opt, sched, ids, labels, lo, hi):
    """Steps ``lo`` to ``hi`` over the fixed batches, the scheduler
    stepped after each: (losses, rates read, K2/K3 bf16 launches)."""
    before = _route_counts(ck)
    losses, lrs = [], []
    for i in range(lo, hi):
        lrs.append(opt.get_lr())
        losses.append(step(ids[i], labels[i]).item())
        sched.step()
    return losses, lrs, {n: _launch_delta(ck, before, n, "bf16")
                         for n in ("flash_fwd", "flash_bwd")}


def _synced(torch, fn):
    """(fn(), seconds on the host clock between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _dir_bytes(*paths):
    import os
    return sum(os.path.getsize(p) for p in paths)


def phase_checkpoint_gpt(torch, ck, smi, tmp):
    """(a) and (b) of the checkpoint path: GPT-124M as
    ``gpt124m_scheduled`` builds it (the nan check off), 8 uninterrupted
    steps (run A, twice: the reruns must agree bit for bit, or their
    difference becomes the gate), then 4 steps, ``paddle.save`` of the
    model's and the optimizer's state, a build from seed 1,
    ``paddle.load`` into both, a new ``CompiledTrainStep`` and 4 more
    steps: steps 5 to 8, the rates, every parameter and every AdamW
    moment must equal run A's. The same resume through
    ``distributed.checkpoint``: a synchronous checkpoint at step 2, an
    asynchronous one at step 4 taken while step 5 runs (its files must
    hold step 4's values), ``mark_complete``, ``latest_checkpoint``; then
    a flipped byte in the step-4 shard must fail the load and send
    ``latest_checkpoint`` back to step 2. K2 and K3 launch 12 times a step
    on the bf16 route throughout."""
    import os

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.distributed import elastic
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.text.gpt import gpt_small
    cfg = gpt_small()
    layers = cfg.num_layers
    shape = (TRAIN_BATCH, cfg.max_seq_len)
    ids, labels = _token_batches(torch, cfg.vocab_size, shape, shape,
                                 cfg.vocab_size)(CKPT_STEPS)
    launches = []

    def build(seed):
        model, opt, sched, step, _ = gpt124m_scheduled(torch, seed=seed,
                                                       check_nan=False)
        return model, opt, sched, step

    def run(parts, lo, hi):
        model, opt, sched, step = parts
        losses, lrs, n = _gpt_run(torch, ck, step, opt, sched, ids, labels,
                                  lo, hi)
        launches.append((hi - lo, n))
        return losses, lrs

    def uninterrupted():
        parts = build(0)
        losses, lrs = run(parts, 0, CKPT_STEPS)
        state = _gpt_state(parts[0], parts[1])
        del parts
        torch.cuda.empty_cache()
        return losses, lrs, state

    a_losses, a_lrs, a_state = uninterrupted()
    r_losses, r_lrs, r_state = uninterrupted()
    rerun_diff = max(_state_diff(torch, r_state, a_state),
                     max(abs(x - y) for x, y in zip(r_losses, a_losses)))
    del r_state

    ckdir = os.path.join(tmp, "elastic")
    p = os.path.join(tmp, "gpt124m")
    parts = build(0)
    b_losses, b_lrs = run(parts, 0, 2)
    model, opt = parts[0], parts[1]
    step2 = elastic.checkpoint_path(2, ckdir)
    _, sync_s = _synced(torch, lambda: dck.save_state_dict(
        {"model": model.state_dict(), "opt": opt.state_dict()}, step2))
    elastic.mark_complete(step2)
    more = run(parts, 2, CKPT_SPLIT)
    b_losses += more[0]
    b_lrs += more[1]
    _, save_s = _synced(torch, lambda: (
        paddle.save(model.state_dict(), p + ".pdparams"),
        paddle.save(opt.state_dict(), p + ".pdopt")))
    nbytes = _dir_bytes(p + ".pdparams", p + ".pdopt")
    step4 = elastic.checkpoint_path(CKPT_SPLIT, ckdir)
    t0 = time.perf_counter()
    handle = dck.save_state_dict(
        {"model": model.state_dict(), "opt": opt.state_dict()}, step4,
        async_save=True)
    blocked_s = time.perf_counter() - t0
    # one more step while the files are written: they must hold step 4
    b5 = run(parts, CKPT_SPLIT, CKPT_SPLIT + 1)[0]
    handle.wait(timeout=600)
    async_s = time.perf_counter() - t0
    elastic.mark_complete(step4)
    del parts, model, opt, handle
    torch.cuda.empty_cache()

    def resumed(load):
        parts = build(1)
        model, opt, sched, step = parts
        (missing, unexpected), load_s = _synced(torch, lambda: load(model,
                                                                    opt))
        if missing or unexpected:
            raise AssertionError(f"the load missed {missing}, found "
                                 f"{unexpected}")
        if opt._step_count != CKPT_SPLIT or sched.last_epoch != CKPT_SPLIT:
            raise AssertionError(
                f"the optimizer resumed at step {opt._step_count}, the "
                f"scheduler at {sched.last_epoch}")
        step = CompiledTrainStep(step.fn, model, opt, amp_level="O2")
        losses, lrs = run((model, opt, sched, step), CKPT_SPLIT, CKPT_STEPS)
        state = _gpt_state(model, opt)
        del parts, model, opt, sched, step
        torch.cuda.empty_cache()
        return losses, lrs, state, load_s

    def load_files(model, opt):
        got = model.set_state_dict(paddle.load(p + ".pdparams"))
        opt.set_state_dict(paddle.load(p + ".pdopt"))
        return got

    found = elastic.latest_checkpoint(ckdir)

    def load_dck(model, opt):
        for q in model.parameters():   # the skeleton's accumulators
            opt._get_accumulators(q)
        skeleton = {"model": model.state_dict(), "opt": opt.state_dict()}
        dck.load_state_dict(skeleton, found)
        opt.set_state_dict(skeleton["opt"])
        return [], []

    results = {"paddle_save": resumed(load_files),
               "distributed_checkpoint": resumed(load_dck)}
    # a flipped byte: the load refuses, latest_checkpoint falls back
    shard = os.path.join(step4, "shard_0.pkl")
    with open(shard, "r+b") as f:
        f.seek(os.path.getsize(shard) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    try:
        dck.load_state_dict({}, step4)
    except ValueError as e:
        corrupt_refused = "corrupt" in str(e)
    else:
        corrupt_refused = False
    fallback = elastic.latest_checkpoint(ckdir)

    out = {"phase": "checkpoint_resume_gpt124m", "nvidia_smi": smi,
           "model": "gpt_small (GPT-124M), CompiledTrainStep O2 bf16, AdamW "
                    "under CosineAnnealingDecay(3e-4, 14), "
                    "ClipGradByGlobalNorm(1.0), seed 0; resumed into a seed-1 "
                    "build", "dropout": 0.0,
           "steps": CKPT_STEPS, "resume_at": CKPT_SPLIT,
           "run_a_losses": a_losses, "run_a_lrs": a_lrs,
           "rerun_bit_equal": rerun_diff == 0.0, "rerun_max_diff": rerun_diff,
           "interrupted_losses_1_to_5": b_losses + b5,
           "checkpoint_bytes": nbytes, "paddle_save_s": save_s,
           "paddle_save_gb_per_s": nbytes / save_s / 1e9,
           "dck_sync_save_s": sync_s, "dck_async_blocked_s": blocked_s,
           "dck_async_write_s": async_s,
           "dck_shard_bytes": _dir_bytes(shard),
           "latest_checkpoint": found, "corrupt_load_refused":
               corrupt_refused, "fallback_checkpoint": fallback,
           "launches_bf16_per_step": [
               {"steps": n, **c} for n, c in launches]}
    failures = []
    for name, (losses, lrs, state, load_s) in results.items():
        diff = max(_state_diff(torch, state, a_state),
                   max(abs(x - y) for x, y in
                       zip(losses, a_losses[CKPT_SPLIT:])))
        out[name] = {"losses_5_to_8": losses, "lrs": lrs, "load_s": load_s,
                     "load_gb_per_s": nbytes / load_s / 1e9,
                     "max_diff_to_run_a": diff}
        if diff > rerun_diff or lrs != a_lrs[CKPT_SPLIT:]:
            failures.append(f"{name}: resumed steps differ from run A by "
                            f"{diff} (reruns: {rerun_diff})")
    emit(out)
    if b_losses + b5 != a_losses[:CKPT_SPLIT + 1] and rerun_diff == 0.0:
        failures.append("the interrupted run's first five losses differ "
                        "from run A's (the async save changed step 5?)")
    if found != step4 or not corrupt_refused or fallback != step2:
        failures.append(f"latest_checkpoint {found}, corrupt load refused "
                        f"{corrupt_refused}, fallback {fallback}")
    bad = [(n, c) for n, c in launches
           if c != {"flash_fwd": layers * n, "flash_bwd": layers * n}]
    if bad:
        failures.append(f"K2/K3 bf16 launches, not 12 a step: {bad}")
    if failures:
        raise AssertionError("; ".join(failures))


class _WorkerCudaCheck:
    """A DataLoader ``worker_init_fn`` (picklable: module level) noting in
    ``mark_dir`` whether CUDA was initialized in the worker, and failing
    the worker when it was."""

    def __init__(self, mark_dir):
        self.mark_dir = mark_dir

    def __call__(self, wid):
        import os

        import torch
        inited = torch.cuda.is_initialized()
        with open(os.path.join(self.mark_dir,
                               f"worker_{wid}_{os.getpid()}"), "w") as f:
            f.write(str(inited))
        if inited:
            raise RuntimeError(f"DataLoader worker {wid} initialized CUDA")


def phase_checkpoint_resnet50_fit(torch, smi, tmp):
    """(c) of the checkpoint path: ResNet-50 through ``Model.fit`` on
    ``phase_resnet50_fit_bf16``'s input (8 x 256 images, O2, Momentum,
    ``steps_per_execution=8``, cuDNN deterministic): 2 epochs with no
    workers; then 1 epoch with 2 worker processes and
    ``ModelCheckpoint``, which must write ``0`` and ``final``; a seed-1
    model ``load``s ``final`` and trains 1 more epoch with 2 workers. Its
    8 losses must equal the uninterrupted run's second epoch bit for bit
    (the same batches in the same order, the same state). Every worker
    notes that CUDA was not initialized in it."""
    import os

    import numpy as np

    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import ModelCheckpoint
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    class FirstBatchTimed(DataLoader):
        """Notes the seconds from the start of each pass to its first
        batch."""
        first_batch_s = None

        def __iter__(self):
            t0 = time.perf_counter()
            it = super().__iter__()
            for i, batch in enumerate(it):
                if i == 0:
                    self.first_batch_s = time.perf_counter() - t0
                yield batch

    block = _image_batches(torch, (RESNET_BATCH, 3, RESNET_SIZE,
                                   RESNET_SIZE), RESNET_CLASSES,
                           device=None)(RESNET_K)
    ds = TensorDataset([block[0].reshape((-1,) + block[0].shape[2:]),
                        block[1].reshape(-1)])
    marks = os.path.join(tmp, "worker_marks")
    os.makedirs(marks)
    save_dir = os.path.join(tmp, "resnet50_ckpt")

    def model_of(seed):
        net = resnet50(num_classes=RESNET_CLASSES, device="cuda", seed=seed)
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=net.parameters())
        return Model(net).prepare(opt, CrossEntropyLoss(), amp_configs="O2")

    def fit(model, workers, epochs, callbacks=()):
        loader = FirstBatchTimed(
            ds, batch_size=RESNET_BATCH, shuffle=False, num_workers=workers,
            worker_init_fn=_WorkerCudaCheck(marks) if workers else None,
            timeout=120)
        rec = fit_recorder(torch)
        model.fit(loader, epochs=epochs, verbose=0,
                  steps_per_execution=RESNET_K,
                  callbacks=[rec, *callbacks])
        return rec, loader

    torch.backends.cudnn.deterministic = True
    try:
        straight, l0 = fit(model_of(0), 0, 2)
        torch.cuda.empty_cache()
        first, _ = fit(model_of(0), 2, 1,
                       [ModelCheckpoint(save_dir=save_dir)])
        files = sorted(os.listdir(save_dir))
        torch.cuda.empty_cache()
        resumed_model = model_of(1)
        _, load_s = _synced(torch, lambda: resumed_model.load(
            os.path.join(save_dir, "final")))
        second, l2 = fit(resumed_model, 2, 1)
        del resumed_model
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    worker_marks = {}
    for name in os.listdir(marks):
        with open(os.path.join(marks, name)) as f:
            worker_marks[name] = f.read()
    images = RESNET_K * RESNET_BATCH
    out = {"phase": "checkpoint_resume_resnet50_fit", "nvidia_smi": smi,
           "entry": "Model(resnet50).prepare(Momentum(0.1, 0.9), "
                    "CrossEntropyLoss(), amp_configs='O2').fit(DataLoader("
                    "TensorDataset(8 x 256 images), batch_size=256, "
                    "num_workers=0 or 2), steps_per_execution=8); "
                    "ModelCheckpoint; Model.load",
           "cudnn_deterministic": True,
           "uninterrupted_losses": straight.losses,
           "interrupted_epoch1_losses": first.losses,
           "resumed_epoch2_losses": second.losses,
           "checkpoint_files": files, "model_load_s": load_s,
           "epoch2_s_workers0": straight.epoch_s[1],
           "epoch2_s_workers2": second.epoch_s[0],
           "images_per_s_epoch2_workers0": images / straight.epoch_s[1],
           "images_per_s_epoch2_workers2": images / second.epoch_s[0],
           "first_batch_s_workers0": l0.first_batch_s,
           "first_batch_s_workers2": l2.first_batch_s,
           "worker_start_s": l2.worker_start_s,
           "images_per_s_epoch2_workers2_after_first_batch":
               images / (second.epoch_s[0] - l2.first_batch_s),
           "worker_cuda_initialized": worker_marks}
    emit(out)
    want_files = ["0.pdopt", "0.pdparams", "final.pdopt", "final.pdparams"]
    if files != want_files:
        raise AssertionError(f"ModelCheckpoint wrote {files}")
    if len(straight.losses) != 2 * RESNET_K or \
            first.losses != straight.losses[:RESNET_K] or \
            second.losses != straight.losses[RESNET_K:]:
        raise AssertionError(
            f"the resumed losses {first.losses} + {second.losses} differ "
            f"from the uninterrupted {straight.losses}")
    if len(worker_marks) != 4 or set(worker_marks.values()) != {"False"}:
        raise AssertionError(f"worker CUDA marks: {worker_marks}")


def phase_checkpoint_resume(torch, ck, smi):
    """The checkpoint path: (a) and (b) on GPT-124M, (c) on ResNet-50,
    their files under one temporary directory, removed at the end."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        phase_checkpoint_gpt(torch, ck, smi, tmp)
        phase_checkpoint_resnet50_fit(torch, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def paged_bound(torch, q, kp, bt, cl):
    """Least time for K1 on these inputs: bytes each slot's visible rows
    need (K and V once, the table entries it reads, q, lens, out) versus
    its flops, at the inputs' type."""
    b, kq, h, d = q.shape
    page = kp.shape[1]
    elt = q.element_size()
    ctxs = cl.tolist()
    toks = sum(c + kq - 1 for c in ctxs if c > 0)
    pages = sum(-(-(c + kq - 1) // page) for c in ctxs if c > 0)
    nbytes = 2 * toks * h * d * elt + 2 * q.numel() * elt + 4 * pages \
        + 4 * b
    flops = sum(4 * h * d * (c + j) for c in ctxs if c > 0
                for j in range(kq))
    return bound_of(nbytes, flops, q.dtype)


def flash_bound(q, k, causal):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    elt = q.element_size()
    nbytes = 2 * q.numel() * elt + 2 * k.numel() * elt + 4 * b * h * sq
    pairs = sum(min(sk, r + sk - sq + 1) for r in range(sq)) if causal \
        else sq * sk
    return bound_of(nbytes, 4 * b * h * d * pairs, q.dtype)


def bound_of(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S[str(dtype)[6:]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_paged(torch, ck, ctxs, kq, dtype, launches, label):
    """K1 on ``paged_case`` inputs: CUDA events over 200 calls and the
    profiler's device time (the split and combine launches) beside its
    bound and its plain version."""
    q, kp, vp, bt, cl = paged_case(torch, ctxs, kq, dtype)

    def kernel():
        return ck.paged_attention_verify_decode(q, kp, vp, bt, cl)

    ms = cuda_time_ms(kernel, 200)
    dev_ms = device_time_ms(kernel)
    plain_ms = cuda_time_ms(
        lambda: ck.paged_attention_verify_reference(q, kp, vp, bt, cl), 20)
    bound_ms, bound_by = paged_bound(torch, q, kp, bt, cl)
    err = max_err(kernel(),
                  ck.paged_attention_verify_reference(q, kp, vp, bt, cl))
    b, _, h, d = q.shape
    shown = ctxs if len(set(ctxs)) > 1 else f"{len(ctxs)} x {ctxs[0]}"
    return {"name": "paged_attention", "route": "cuda",
            "source": ck.PAGED_ATTENTION.source,
            "replaces": ck.PAGED_ATTENTION.replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": dev_ms, "case": label,
            "shape": f"B={b} KQ={kq} h={h} d={d} page={kp.shape[1]} "
                     f"ctx={shown} {str(dtype)[6:]}"}


def time_flash(torch, ck, case, dtype, launches):
    label, b, sq, sk, h, kh, d, causal = case
    q, k, v = flash_case(torch, b, sq, sk, h, kh, d, dtype)
    ms = cuda_time_ms(
        lambda: ck.flash_attention_with_lse(q, k, v, causal=causal), 100)
    dev_ms = device_time_ms(
        lambda: ck.flash_attention_with_lse(q, k, v, causal=causal))
    plain_ms = cuda_time_ms(
        lambda: ck.flash_attention_reference(q, k, v, causal=causal), 10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    same = sdpa_same_function(q, k)
    library_ms = cuda_time_ms(
        lambda: sdpa(qt, kt, vt, is_causal=causal), 100) if same else None
    library_dev_ms = device_time_ms(
        lambda: sdpa(qt, kt, vt, is_causal=causal)) if same else None
    bound_ms, bound_by = flash_bound(q, k, causal)
    ref = ck.flash_attention_reference(q, k, v, causal)[0]
    err = max_err(ck.flash_attention_with_lse(q, k, v, causal)[0], ref)
    lib_err = max_err(sdpa_forward(torch, q, k, v, causal), ref) \
        if same else None
    return {"name": "flash_fwd", "route": "cuda",
            "source": ck.FLASH_FWD.source, "replaces": ck.FLASH_FWD.replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_call": "torch.nn.functional."
                            "scaled_dot_product_attention",
            "library_max_abs_err": lib_err, "device_ms": dev_ms,
            "library_device_ms": library_dev_ms,
            "shape": f"[{b}, {sq}, {h}, {d}] kv [{b}, {sk}, {kh}, {d}] "
                     f"causal={causal} {str(dtype)[6:]}"}


def flash_bwd_bound(q, k, causal):
    """Least time for K3: q, k, v, o, do read and dq, dk, dv written once,
    lse read once, against 10 * d flops per visible (q, kv) pair."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    elt = q.element_size()
    nbytes = 5 * q.numel() * elt + 3 * k.numel() * elt + 4 * b * h * sq
    pairs = sum(min(sk, r + sk - sq + 1) for r in range(sq)) if causal \
        else sq * sk
    return bound_of(nbytes, 10 * b * h * d * pairs, q.dtype)


def time_flash_bwd(torch, ck, case, dtype, launches):
    label, b, sq, sk, h, kh, d, causal = case
    args = flash_bwd_inputs(torch, ck, b, sq, sk, h, kh, d, causal, dtype,
                            dlse=False)
    q, k, v, o, lse, do, _ = args
    ms = cuda_time_ms(lambda: ck.flash_attention_bwd(*args, causal=causal),
                      20)
    # the wrapper's device time: delta = rowsum(do * o), then the two passes
    dev_ms = device_time_ms(
        lambda: ck.flash_attention_bwd(*args, causal=causal))
    plain_ms = cuda_time_ms(
        lambda: ck.flash_attention_bwd_reference(*args, causal=causal), 5,
        warmup=1)
    # yardstick: the backward alone of PyTorch's fused attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2).contiguous()
    library_ms = cuda_time_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True), 20)
    library_dev_ms = device_time_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True))
    bound_ms, bound_by = flash_bwd_bound(q, k, causal)
    ref = ck.flash_attention_bwd_reference(*args, causal=causal)
    err = max(max_err(a, r) for a, r in zip(
        ck.flash_attention_bwd(*args, causal=causal), ref))
    lib_err = max(max_err(a, r) for a, r in zip(
        sdpa_backward(torch, q, k, v, do, causal), ref))
    return {"name": "flash_bwd", "route": "cuda",
            "source": ck.FLASH_BWD.source, "replaces": ck.FLASH_BWD.replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_call": "backward of torch.nn.functional."
                            "scaled_dot_product_attention",
            "library_max_abs_err": lib_err, "device_ms": dev_ms,
            "library_device_ms": library_dev_ms,
            "shape": f"[{b}, {sq}, {h}, {d}] kv [{b}, {sk}, {kh}, {d}] "
                     f"causal={causal} {str(dtype)[6:]}"}


def packed_bound(q, k, cu, pairs, backward):
    """Least time for K4 (q, k, v, o, lse and cu moved once against
    4 * d flops per visible pair and head) or K5 (q, k, v, o, do, dq, dk,
    dv, lse, delta and cu against 10 * d)."""
    tq, h, d = q.shape
    elt = q.element_size()
    stats = 4 * h * tq
    if backward:
        nbytes = 4 * q.numel() * elt + 4 * k.numel() * elt + 2 * stats
    else:
        nbytes = 2 * q.numel() * elt + 2 * k.numel() * elt + stats
    flops = (10 if backward else 4) * d * h * pairs
    return bound_of(nbytes + 4 * cu.numel(), flops, q.dtype)


def time_packed(torch, ck, launches, dtype=None):
    """K4 and K5 at the packed-attention shape, each beside its plain
    version and the varlen flash op PyTorch ships
    (``torch.ops.aten._flash_attention_forward`` / ``_backward`` with
    cum_seq_q / cum_seq_k), which the port never calls; by CUDA events and
    by profiler device time (the library's backward reads host-bound on
    the events)."""
    dtype = dtype or torch.bfloat16
    lens, q, k, v, do, cu = packed_attention(torch, dtype)
    q, k, v = q.detach(), k.detach(), v.detach()
    tq, h, d = q.shape
    longest = max(lens)
    pairs = visible_pairs(lens, lens, True)
    plan = ck.varlen_plan(cu, cu, tq, tq, True)
    plan_ms = cuda_time_ms(lambda: ck.varlen_plan(cu, cu, tq, tq, True), 20)
    o, lse = ck.flash_attention_varlen_fwd(q, k, v, cu, cu, True, plan=plan)
    ro, rlse = ck.flash_attention_varlen_reference(q, k, v, cu, cu, True)
    bargs = (q, k, v, o, lse, do, cu, cu, True)
    dgot = ck.flash_attention_varlen_bwd(*bargs, plan=plan)
    dref = ck.flash_attention_varlen_bwd_reference(*bargs)
    lib = varlen_library_fwd(torch, q, k, v, cu, cu, longest, longest, True)

    def kernel_fwd():
        return ck.flash_attention_varlen_fwd(q, k, v, cu, cu, True,
                                             plan=plan)

    def kernel_bwd():
        return ck.flash_attention_varlen_bwd(*bargs, plan=plan)

    def library_fwd():
        return varlen_library_fwd(torch, q, k, v, cu, cu, longest, longest,
                                  True)

    def library_bwd():
        return varlen_library_bwd(torch, do, q, k, v, lib, cu, cu, longest,
                                  longest, True)

    shape = (f"T={tq} ({len(lens)} causal segments of {min(lens)} to "
             f"{longest}) h={h} d={d} {str(dtype)[6:]}")
    fwd_bound, fwd_by = packed_bound(q, k, cu, pairs, backward=False)
    bwd_bound, bwd_by = packed_bound(q, k, cu, pairs, backward=True)
    rows = [
        {"name": "flash_varlen_fwd", "route": "cuda",
         "source": ck.FLASH_VARLEN_FWD.source,
         "replaces": ck.FLASH_VARLEN_FWD.replaces,
         "launches": launches["flash_varlen_fwd"],
         "max_abs_err": max_err(o, ro),
         "ms": cuda_time_ms(kernel_fwd, 20),
         "plain_ms": cuda_time_ms(lambda: ck.flash_attention_varlen_reference(
             q, k, v, cu, cu, True), 5, warmup=1),
         "bound_ms": fwd_bound, "bound_by": fwd_by,
         "library_ms": cuda_time_ms(library_fwd, 20),
         "library_call": "torch.ops.aten._flash_attention_forward "
                         "(cum_seq_q, cum_seq_k)",
         "library_max_abs_err": max_err(lib[0], ro),
         "device_ms": device_time_ms(kernel_fwd),
         "library_device_ms": device_time_ms(library_fwd),
         "plan_ms": plan_ms, "visible_pairs_per_head": pairs,
         "shape": shape},
        {"name": "flash_varlen_bwd", "route": "cuda",
         "source": ck.FLASH_VARLEN_BWD.source,
         "replaces": ck.FLASH_VARLEN_BWD.replaces,
         "launches": launches["flash_varlen_bwd"],
         "max_abs_err": max(max_err(a, r) for a, r in zip(dgot, dref)),
         "ms": cuda_time_ms(kernel_bwd, 20),
         "plain_ms": cuda_time_ms(
             lambda: ck.flash_attention_varlen_bwd_reference(*bargs), 5,
             warmup=1),
         "bound_ms": bwd_bound, "bound_by": bwd_by,
         "library_ms": cuda_time_ms(library_bwd, 20),
         "library_call": "torch.ops.aten._flash_attention_backward "
                         "(cum_seq_q, cum_seq_k)",
         "library_max_abs_err": max(max_err(a, r)
                                    for a, r in zip(library_bwd(), dref)),
         # the wrapper's device time: delta = rowsum(do * o), then the two
         # passes; the library's its own preprocessing and passes
         "device_ms": device_time_ms(kernel_bwd),
         "library_device_ms": device_time_ms(library_bwd),
         "visible_pairs_per_head": pairs, "shape": shape}]
    return rows


def phase_timing(torch, ck, launches, path_launches, routes, smi):
    """The kernels line: each kernel at its main path's shape with its
    launches over every path, then K2 and K3 at the encoder paths'
    non-causal shapes with those paths' own launches, then each kernel's
    fp16 route (K2 and K3 at the fp16 AMP path's shape) with its fp16
    launches over every path (``routes``)."""
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    main = [time_paged(torch, ck, PAGED_CTXS[1], 1, bf16,
                       launches["paged_attention"], "serving"),
            time_flash(torch, ck, FLASH_CASES[0], bf16,
                       launches["flash_fwd"]),
            time_flash_bwd(torch, ck, TRAIN_ATTENTION, bf16,
                           launches["flash_bwd"]),
            *time_packed(torch, ck, launches)]
    for case, path in ((ERNIE_ATTENTION, "ernie_pretraining"),
                       (BERT_ATTENTION, "bert_finetune")):
        counts = path_launches[path]
        for row in (time_flash(torch, ck, case, bf16, counts["flash_fwd"]),
                    time_flash_bwd(torch, ck, case, bf16,
                                   counts["flash_bwd"])):
            row.update(case=case[0], launches_path=path)
            main.append(row)
    fp16 = {name: sum(r[name]["fp16"] for r in routes.values())
            for name in launches}
    for row in (time_paged(torch, ck, PAGED_CTXS[1], 1, f16,
                           fp16["paged_attention"], "serving_fp16"),
                time_flash(torch, ck, TRAIN_ATTENTION, f16,
                           fp16["flash_fwd"]),
                time_flash_bwd(torch, ck, TRAIN_ATTENTION, f16,
                               fp16["flash_bwd"]),
                *time_packed(torch, ck, fp16, f16)):
        row.update(route_dtype="fp16", launches_route="fp16")
        row.setdefault("case", "gpt124m_fp16_amp"
                       if row["name"] in ("flash_fwd", "flash_bwd")
                       else "packed_fp16")
        main.append(row)
    variants = [time_paged(torch, ck, PAGED_CTXS[5], 5, bf16, None,
                           "serving_verify"),
                time_paged(torch, ck, PAGED_BYTES_CTXS, 1, bf16, None,
                           "bytes_heavy"),
                time_paged(torch, ck, PAGED_CTXS[1], 1, f32, None,
                           "serving_fp32"),
                time_flash(torch, ck, FLASH_CASES[0], f32, None),
                time_flash(torch, ck, TRAIN_ATTENTION, bf16, None)]
    emit({"phase": "kernel_variants", "nvidia_smi": smi,
          "kernels": variants})
    return main


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script measures the port on "
              "one", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    smi = phase_environment(torch, ck)
    phase_kernels_vs_plain(torch, ck)
    # the main paths, each counted from zero: serving (K1) with the fp32
    # model phase (K2), training (K2, K3), eager fp16 AMP training (K2, K3
    # on their fp16 route), training with the schedule, nan check and
    # StepMeter (K2, K3), packed attention (K4, K5), ERNIE pretraining and
    # BERT finetuning (K2, K3, non-causal), then ResNet-50 and LeNet
    # training (none), then the paddle.* surface (K2, K3), then the
    # checkpoint path (K2, K3 on GPT-124M's resumes; none on ResNet-50's)
    paths = (("serving", ("paged_attention", "flash_fwd"),
              lambda: (phase_serving(torch, ck, smi),
                       phase_exactness_fp32(torch, ck))),
             # the engine's prefill is dense in both packages: K1 is the
             # one hand-written kernel on the fleet's path
             ("serving_fleet", ("paged_attention",),
              lambda: phase_serving_fleet(torch, ck, smi)),
             ("training", ("flash_fwd", "flash_bwd"),
              lambda: (phase_training_bf16(torch, ck, smi),
                       phase_training_exactness_fp32(torch, ck))),
             ("gpt124m_fp16_amp", ("flash_fwd", "flash_bwd"),
              lambda: (phase_gpt124m_fp16_amp(torch, ck, smi),
                       phase_fp16_against_fp32(torch, ck))),
             ("gpt124m_scheduled", ("flash_fwd", "flash_bwd"),
              lambda: (phase_gpt124m_scheduled(torch, ck, smi),
                       phase_eager_exactness_fp32(torch, ck))),
             ("packed_attention", ("flash_varlen_fwd", "flash_varlen_bwd"),
              lambda: (phase_packed_attention_bf16(torch, ck, smi),
                       phase_packed_attention_exactness_fp32(torch, ck))),
             ("ernie_pretraining", ("flash_fwd", "flash_bwd"),
              lambda: (phase_training_bf16(torch, ck, smi, "ernie"),
                       phase_ernie_exactness_fp32(torch, ck))),
             ("bert_finetune", ("flash_fwd", "flash_bwd"),
              lambda: (phase_training_bf16(torch, ck, smi, "bert"),
                       phase_bert_exactness_fp32(torch, ck))),
             # no hand-written kernel on this path, as in the reference
             ("resnet50_training", (), lambda: phase_vision(torch, ck, smi)),
             ("paddle_surface", ("flash_fwd", "flash_bwd"),
              lambda: phase_paddle_surface(torch, ck, smi)),
             ("checkpoint_resume", ("flash_fwd", "flash_bwd"),
              lambda: phase_checkpoint_resume(torch, ck, smi)))
    launches = {k.name: 0 for k in ck.KERNELS}
    path_launches, path_routes, path_seconds = {}, {}, {}
    for path, kernels, drive in paths:
        ck.reset_launch_counts()
        t_path = time.perf_counter()
        drive()
        path_seconds[path] = time.perf_counter() - t_path
        counts = {k.name: k.launches for k in ck.KERNELS}
        missing = [n for n in kernels if counts[n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
        if not kernels and any(counts.values()):
            raise AssertionError(f"the {path} path launched {counts}")
        path_launches[path] = counts
        path_routes[path] = {k.name: dict(k.route_launches)
                             for k in ck.KERNELS}
        for name, c in counts.items():
            launches[name] += c
    emit({"phase": "path_launches", "launches": path_launches,
          "by_route": path_routes, "seconds": path_seconds})
    kernels = phase_timing(torch, ck, launches, path_launches, path_routes,
                           smi)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
