#!/usr/bin/env python3
"""The observability path of ``chip_smoke.py`` alone, on one NVIDIA card,
with a record of where the profiler's kernel events go.

Run from the root of a checkout on a machine with one card:

    PYTHONPATH=. python3 scripts/chip_observability.py

It builds the kernels, then reads K2 and K3 at [16, 1024, 12, 64] causal
bf16 under the profiler after each of a series of things the full script
does before its timings: nothing (a fresh process), K1 launched through
ctypes, CUDA graphs captured and replayed (the chain method), forty
profiler sessions, the observability path itself; then thirty K1
sessions in a row through ``device_time_ms``, with the ones it had to
take again. Each reading gives the
kernels' device events as CUPTI recorded them (count and device ms, the
port profiler's table), the sum of ``self_device_time_total`` over
``key_averages()`` (the reading the script used before), and the least
delay from a kernel's launch call to its start, with the profiler's
word on whether its table is whole. Then it drives
``chip_smoke.phase_observability`` with the launch counts set to 0 just
before it, prints the counts, and reads K2 and K3 by events, profiler
and graph (``kernel_readings``). Each phase prints one JSON line; a gate
that fails raises. Without a card it exits 2.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def key_averages_ms(torch, fn, iters=20):
    """Mean device ms per call as ``key_averages()`` sums it."""
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


def profiled(torch, fn, kernels, iters=20):
    """The port profiler's view of ``iters`` calls: per kernel pattern the
    events and device ms, every device row, the clock and launch delays."""
    from paddle_tpu_torch import profiler
    fn()
    torch.cuda.synchronize()
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU,
                                      profiler.ProfilerTarget.GPU])
    prof.start()
    for _ in range(iters):
        fn()
    prof.stop()
    delays = sorted(e["args"]["launch_delay_us"] for e in prof.device_events
                    if "launch_delay_us" in e["args"])
    return {"kernels": {k: [sum(c for n, (c, _) in prof.device_ops.items()
                                if k in n),
                            sum(s for n, (_, s) in prof.device_ops.items()
                                if k in n) * 1e3 / iters]
                        for k in kernels},
            "device_events": len(prof.device_events),
            "device_ms_per_call": sum(s for _, s in prof.device_ops.values())
            * 1e3 / iters,
            "launch_delay_us": [delays[0], delays[len(delays) // 2],
                                delays[-1]] if delays else None,
            "whole": prof.whole, "clock": prof.clock}


def readings(torch, ck, cs, stage, t0):
    label, b, sq, sk, h, kh, d, causal = cs.TRAIN_ATTENTION
    bf16 = torch.bfloat16
    q, k, v = cs.flash_case(torch, b, sq, sk, h, kh, d, bf16)
    args = cs.flash_bwd_inputs(torch, ck, b, sq, sk, h, kh, d, causal, bf16,
                               dlse=False)
    out = {"phase": "profiler_readings", "stage": stage,
           "process_s": time.perf_counter() - t0}
    for name, fn, kernels in (
            ("flash_fwd", lambda: ck.flash_attention_with_lse(
                q, k, v, causal=causal), cs.K2_KERNELS),
            ("flash_bwd", lambda: ck.flash_attention_bwd(
                *args, causal=causal), cs.K3_KERNELS)):
        out[name] = {"key_averages_ms": key_averages_ms(torch, fn),
                     "profiler": profiled(torch, fn, kernels)}
    cs.emit(out)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_observability: no CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    import chip_smoke as cs
    from paddle_tpu_torch.observability import metrology
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_environment(torch, ck)
    readings(torch, ck, cs, "fresh", t0)
    q, kp, vp, bt, cl = cs.paged_case(torch, cs.PAGED_CTXS[1], 1,
                                      torch.bfloat16)
    for _ in range(200):
        ck.paged_attention_verify_decode(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    readings(torch, ck, cs, "after K1 through ctypes", t0)
    with ck.recording_launches():
        sample = metrology.chain_sampler(
            lambda: ck.paged_attention_verify_decode(q, kp, vp, bt, cl), 20,
            torch.device("cuda"))
    for _ in range(10):
        sample()
    readings(torch, ck, cs, "after CUDA graphs", t0)
    x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    for _ in range(40):
        cs.device_time_ms(lambda: x @ x, iters=2)
    readings(torch, ck, cs, "after 40 profiler sessions", t0)
    ck.reset_launch_counts()
    t_path = time.perf_counter()
    cs.phase_observability(torch, ck, smi)
    counts = {k.name: dict(k.route_launches) for k in ck.KERNELS}
    cs.emit({"phase": "observability_path_launches", "launches": counts,
             "seconds": time.perf_counter() - t_path})
    readings(torch, ck, cs, "after the observability path", t0)
    # sessions in a row, as phase_timing takes them: how many come back
    # not whole (cs.PROFILER_RETAKES)
    def k1():
        return ck.paged_attention_verify_decode(q, kp, vp, bt, cl)

    for _ in range(30):
        cs.device_time_ms(k1, kernels=cs.paged_kernels(torch.bfloat16))
    cs.emit({"phase": "profiler_sessions", "sessions": 30,
             "retakes": cs.PROFILER_RETAKES})
    cs.emit({"phase": "kernel_readings", "nvidia_smi": smi,
             "cases": cs.kernel_readings(torch, ck)})
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
