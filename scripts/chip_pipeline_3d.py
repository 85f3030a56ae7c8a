#!/usr/bin/env python3
"""The pipeline_3d path of ``chip_smoke.py`` alone, on one NVIDIA card.

Run from the root of a checkout on a machine with one card:

    PYTHONPATH=. python3 scripts/chip_pipeline_3d.py

It builds the kernels, holds K2 and K3 at the path's shapes
(``chip_smoke.P3_ATTENTION``: an mp rank's microbatch of the bf16 steps and
of the fp32 gate) against their plain versions in bf16, fp16 and fp32,
drives ``chip_smoke.phase_pipeline_3d`` with the launch counts set to 0
just before it (eight gloo ranks at pp 2 x sharding 2 x mp 2: the fp32
gates held to one process, the checkpoint round trip, GPT-124M's timed
steps; then the checkpoint loaded whole here), prints the counts, then
times K2 and K3 at the bf16 microbatch beside their bounds, plain versions
and ``scaled_dot_product_attention``. Each phase prints one JSON line; any
failure raises. Without a card it exits 2.
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
        print("chip_pipeline_3d: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_environment(torch, ck)
    rows = []
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        got = [cs.flash_fwd_case(torch, ck, *case, dtype)
               for case in cs.P3_ATTENTION]
        got += [cs.flash_bwd_case(torch, ck, *case, dtype)
                for case in cs.P3_ATTENTION]
        if dtype != torch.float32:
            cs.hold_bf16_to_library(got)
        rows += got
    cs.emit({"phase": "p3_kernels_vs_plain", "cases": rows})
    bad = [r for r in rows if not r["pass"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    cs.phase_pipeline_3d(torch, ck, smi)
    counts = {k.name: dict(k.route_launches) for k in ck.KERNELS}
    cs.emit({"phase": "p3_path_launches", "launches": counts,
             "seconds": time.perf_counter() - t0})
    case, bf16 = cs.P3_ATTENTION[0], torch.bfloat16
    kernels = [cs.time_flash(torch, ck, case, bf16,
                             counts["flash_fwd"]["bf16"]),
               cs.time_flash_bwd(torch, ck, case, bf16,
                                 counts["flash_bwd"]["bf16"])]
    for row in kernels:
        row.update(case=case[0], launches_path="pipeline_3d")
    cs.emit({"kernels": kernels})
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
