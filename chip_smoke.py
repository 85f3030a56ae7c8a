#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``paddle_tpu_torch/csrc``
with ``nvcc`` (one process per source, all at once), holds each kernel
against its plain PyTorch version at the serving path's shapes, serves
GPT-124M at full width (random weights from a seed) through
``ServingEngine`` with and without speculative decoding, checks the fp32
engine's greedy tokens against the port's own ``generate`` and a
full-width forward against the dense path, and times each kernel beside
its bound, its plain version and, where one exists, a PyTorch call that
computes the same function. Each phase prints one JSON line; any failure
raises and the script exits non-zero. It needs a CUDA card: without one
it exits 2 and prints no result.

fp32 comparisons run with TF32 off in cuBLAS and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``).

The last line is ``{"ok": true, "device": {"platform": "gpu", "kind":
<torch.cuda.get_device_name(0)>, "count": <device count>}}``; the line
before it lists every kernel with its launches on the main path
(serving plus the fp32 model phase), time, bound, plain time and library
time.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, per type
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
    ptxas = {name: [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                    if "Used" in ln]
             for name, (_, log) in built.items()}
    emit({"phase": "environment", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_wall_s": wall,
          "build_s": {n: s for n, (s, _) in built.items()},
          "ptxas": ptxas})
    return smi


# -- phase 2 ------------------------------------------------------------------
def paged_case(torch, ctxs, kq, dtype, h=12, d=64, page=16, seed=0):
    """Pools with each slot's pages scattered through them, tables padded
    with the null page. Row j of slot b sees ctxs[b] + j tokens."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(ctxs)
    need = [(c + kq - 1 + page - 1) // page if c else 0 for c in ctxs]
    maxp = max(max(need), 1)
    npages = 1 + sum(need)
    perm = (torch.randperm(npages - 1, generator=g) + 1).tolist()
    tables, nxt = [], 0
    for n in need:
        tables.append(perm[nxt:nxt + n] + [0] * (maxp - n))
        nxt += n
    dev = "cuda"
    q = torch.randn(b, kq, h, d, generator=g).to(dev, dtype)
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
FLASH_CASES = [   # (label, b, sq, sk, h, kh, d, causal)
    ("gpt124m_causal", 1, 1024, 1024, 12, 12, 64, True),
    ("gqa_causal", 2, 256, 256, 12, 4, 64, True),
    ("nonsquare_causal", 1, 128, 384, 12, 12, 64, True),
    ("d128_causal", 1, 512, 512, 8, 8, 128, True),
    ("noncausal", 1, 256, 512, 12, 12, 64, False),
]


def phase_kernels_vs_plain(torch, ck):
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for kq, ctxs in PAGED_CTXS.items():
            q, kp, vp, bt, cl = paged_case(torch, ctxs, kq, dtype)
            got = ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
            torch.cuda.synchronize()
            ref = ck.paged_attention_verify_reference(q, kp, vp, bt, cl)
            # fp32: K*eps with K the longest context; bf16: the CPU
            # tests' bound for bf16 pools
            tol = (max(ctxs) + kq) * F32_EPS if dtype == torch.float32 \
                else 48 * 2.0 ** -8
            err = max_err(got, ref)
            zero_rows_exact = bool((got[0] == 0).all()) and \
                not bool(torch.signbit(got[0].float()).any())
            results.append({"kernel": "paged_attention", "kq": kq,
                            "dtype": str(dtype)[6:], "max_abs_err": err,
                            "tol": tol, "inactive_rows_exact_zero":
                            zero_rows_exact,
                            "pass": err <= tol and zero_rows_exact})
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, sq, sk, h, kh, d, causal in FLASH_CASES:
            q, k, v = flash_case(torch, b, sq, sk, h, kh, d, dtype)
            o, lse = ck.flash_attention_with_lse(q, k, v, causal=causal)
            torch.cuda.synchronize()
            ro, rlse = ck.flash_attention_reference(q, k, v, causal=causal)
            # fp32: the JAX package's flash-forward tolerance; bf16: two
            # ulps of an output below 2 (both round one fp32 result)
            tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6
            err_o = max_err(o, ro)
            err_lse = max_err(lse, rlse)
            results.append({"kernel": "flash_fwd", "case": label,
                            "dtype": str(dtype)[6:], "max_abs_err": err_o,
                            "lse_max_abs_err": err_lse, "tol": tol,
                            "lse_tol": 1e-4,
                            "pass": err_o <= tol and err_lse <= 1e-4})
    emit({"phase": "kernels_vs_plain", "cases": results})
    bad = [r for r in results if not r["pass"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    return results


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


def run_engine(torch, model, requests, **cfg):
    from paddle_tpu_torch.inference.serving import (ServingConfig,
                                                    ServingEngine)
    from paddle_tpu_torch.observability.metrics import percentile
    eng = ServingEngine(model, ServingConfig(page_size=16, max_batch=8,
                                             **cfg), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in requests:
        eng.submit(r)
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    new_tokens = sum(len(r.output_tokens) for r in requests)
    return eng, {
        "requests": len(requests), "new_tokens": new_tokens,
        "wall_s": wall, "tokens_per_s": new_tokens / wall,
        "ttft_p50_ms": percentile([r.ttft_s * 1e3 for r in requests], 0.5),
        "tpot_p50_ms": percentile([r.tpot_s * 1e3 for r in requests
                                   if r.tpot_s is not None], 0.5),
        "dispatches": eng.decode_steps,
        "prefix_hit_requests": sum(r.prefix_hit_tokens > 0
                                   for r in requests),
    }


def phase_serving(torch, ck, smi):
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
    before = ck.PAGED_ATTENTION.launches
    dispatches = 0
    tokens = {}
    for label, spec_k in (("spec_off", 0), ("spec_k4", 4)):
        reqs = serving_requests(torch, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        eng, stats = run_engine(torch, model, reqs, spec_k=spec_k)
        stats["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        if spec_k:
            stats["verify_steps"] = eng.spec_verify_steps
            stats["accepted_drafts"] = eng.spec_accepted_total
        out[label] = stats
        dispatches += eng.decode_steps
        tokens[label] = [r.output_tokens for r in reqs]
        if any(len(r.output_tokens) != 32 for r in reqs):
            raise AssertionError(f"{label}: a request did not get its 32 "
                                 "tokens")
        if stats["prefix_hit_requests"] < 1:
            raise AssertionError(f"{label}: no prefix-cache hit")
    launches = ck.PAGED_ATTENTION.launches - before
    out["paged_attention_launches"] = launches
    out["dispatches"] = dispatches
    out["spec_on_off_same_tokens"] = tokens["spec_off"] == tokens["spec_k4"]
    emit(out)
    if launches != cfg.num_layers * dispatches:
        raise AssertionError(
            f"paged attention launched {launches} times for {dispatches} "
            f"dispatches of {cfg.num_layers} layers")


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


# -- phase 5 ------------------------------------------------------------------
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


def time_paged(torch, ck, kq, dtype, launches):
    q, kp, vp, bt, cl = paged_case(torch, PAGED_CTXS[kq], kq, dtype)
    ms = cuda_time_ms(
        lambda: ck.paged_attention_verify_decode(q, kp, vp, bt, cl), 200)
    plain_ms = cuda_time_ms(
        lambda: ck.paged_attention_verify_reference(q, kp, vp, bt, cl), 20)
    bound_ms, bound_by = paged_bound(torch, q, kp, bt, cl)
    err = max_err(ck.paged_attention_verify_decode(q, kp, vp, bt, cl),
                  ck.paged_attention_verify_reference(q, kp, vp, bt, cl))
    return {"name": "paged_attention", "route": "cuda",
            "source": ck.PAGED_ATTENTION.source,
            "replaces": ck.PAGED_ATTENTION.replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": f"B=8 KQ={kq} h=12 d=64 page=16 ctx={PAGED_CTXS[kq]} "
                     f"{str(dtype)[6:]}"}


def time_flash(torch, ck, case, dtype, launches):
    label, b, sq, sk, h, kh, d, causal = case
    q, k, v = flash_case(torch, b, sq, sk, h, kh, d, dtype)
    ms = cuda_time_ms(
        lambda: ck.flash_attention_with_lse(q, k, v, causal=causal), 100)
    plain_ms = cuda_time_ms(
        lambda: ck.flash_attention_reference(q, k, v, causal=causal), 10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(
        lambda: sdpa(qt, kt, vt, is_causal=causal), 100) \
        if kh == h and sq == sk else None
    bound_ms, bound_by = flash_bound(q, k, causal)
    err = max_err(ck.flash_attention_with_lse(q, k, v, causal)[0],
                  ck.flash_attention_reference(q, k, v, causal)[0])
    return {"name": "flash_fwd", "route": "cuda",
            "source": ck.FLASH_FWD.source, "replaces": ck.FLASH_FWD.replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": f"[{b}, {sq}, {h}, {d}] kv [{b}, {sk}, {kh}, {d}] "
                     f"causal={causal} {str(dtype)[6:]}"}


def phase_timing(torch, ck, launches, smi):
    bf16, f32 = torch.bfloat16, torch.float32
    main = [time_paged(torch, ck, 1, bf16, launches["paged_attention"]),
            time_flash(torch, ck, FLASH_CASES[0], bf16,
                       launches["flash_fwd"])]
    variants = [time_paged(torch, ck, 5, bf16, None),
                time_paged(torch, ck, 1, f32, None),
                time_flash(torch, ck, FLASH_CASES[0], f32, None)]
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
    # the main path: serving (K1) and the fp32 model phase (K2), counted
    # from zero
    ck.reset_launch_counts()
    phase_serving(torch, ck, smi)
    phase_exactness_fp32(torch, ck)
    launches = {k.name: k.launches for k in ck.KERNELS}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    kernels = phase_timing(torch, ck, launches, smi)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
