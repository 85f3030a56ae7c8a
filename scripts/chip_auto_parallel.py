#!/usr/bin/env python3
"""The auto_parallel path of ``chip_smoke.py`` alone, on one NVIDIA card.

Run from the root of a checkout on a machine with one card:

    PYTHONPATH=. python3 scripts/chip_auto_parallel.py

It builds the kernels, holds K2 and K3 at the path's shapes (the Engine
ranks' ``chip_smoke.AP_ATTENTION`` and the fleet executor's microbatch)
against their plain versions in bf16, fp16 and fp32, drives
``chip_smoke.phase_auto_parallel`` with the launch counts set to 0 just
before it (the two gloo Engine ranks, the fp32 gate against one process,
the fleet executor here), prints the counts, then times K2 and K3 at the
Engine ranks' shape in fp32 and K2 at the executor's in bf16, beside their
bounds, plain versions and ``scaled_dot_product_attention``. Each phase
prints one JSON line; any failure raises. Without a card it exits 2.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_auto_parallel: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_environment(torch, ck)
    executor = ("ap_executor_microbatch",) + cs.PP_ATTENTION[0][1:]
    rows = []
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        got = [cs.flash_fwd_case(torch, ck, *case, dtype)
               for case in (cs.AP_ATTENTION, executor)]
        got += [cs.flash_bwd_case(torch, ck, *cs.AP_ATTENTION, dtype)]
        if dtype != torch.float32:
            cs.hold_bf16_to_library(got)
        rows += got
    cs.emit({"phase": "ap_kernels_vs_plain", "cases": rows})
    bad = [r for r in rows if not r["pass"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    cs.phase_auto_parallel(torch, ck, smi)
    counts = {k.name: dict(k.route_launches) for k in ck.KERNELS}
    cs.emit({"phase": "ap_path_launches", "launches": counts,
             "seconds": time.perf_counter() - t0})
    f32 = torch.float32
    kernels = [cs.time_flash(torch, ck, cs.AP_ATTENTION, f32,
                             counts["flash_fwd"]["fp32"]),
               cs.time_flash_bwd(torch, ck, cs.AP_ATTENTION, f32,
                                 counts["flash_bwd"]["fp32"]),
               cs.time_flash(torch, ck, executor, torch.bfloat16,
                             counts["flash_fwd"]["bf16"])]
    for row, case in zip(kernels, (cs.AP_ATTENTION, cs.AP_ATTENTION,
                                   executor)):
        row.update(case=case[0], launches_path="auto_parallel")
    cs.emit({"kernels": kernels})
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
