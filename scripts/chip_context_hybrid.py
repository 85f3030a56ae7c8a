#!/usr/bin/env python3
"""The context_hybrid path of ``chip_smoke.py`` alone, on one NVIDIA card.

Run from the root of a checkout on a machine with one card:

    PYTHONPATH=. python3 scripts/chip_context_hybrid.py

It builds the kernels, holds K2 and K3 at the path's shapes
(``chip_smoke.CH_ATTENTION``: a rank's zigzag ring blocks and Ulysses'
whole sequence at sharding 2 x sep 2 x mp 2 on GPT-124M's 2 x 8192)
against their plain versions in bf16, fp16 and fp32, drives
``chip_smoke.phase_context_hybrid`` with the launch counts set to 0 just
before it (eight gloo ranks: the fp32 SP + CP gates under ZeRO held to one
process, the checkpoint round trip, GPT-124M's timed ring steps, the pipe
gate at pp 2 x sharding 2 x sep 2; then the checkpoint loaded whole here),
prints the counts, then times K2 and K3 at each shape beside their bounds,
plain versions and ``scaled_dot_product_attention``. Each phase prints one
JSON line; any failure raises. Without a card it exits 2.
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
        print("chip_context_hybrid: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_environment(torch, ck)
    rows = []
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        got = [cs.flash_fwd_case(torch, ck, *case, dtype)
               for case in cs.CH_ATTENTION]
        got += [cs.flash_bwd_case(torch, ck, *case, dtype)
                for case in cs.CH_ATTENTION]
        if dtype != torch.float32:
            cs.hold_bf16_to_library(got)
        rows += got
    cs.emit({"phase": "ch_kernels_vs_plain", "cases": rows,
             "seconds": time.perf_counter() - t0})
    bad = [r for r in rows if not r["pass"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    cs.phase_context_hybrid(torch, ck, smi)
    counts = {k.name: dict(k.route_launches) for k in ck.KERNELS}
    cs.emit({"phase": "ch_path_launches", "launches": counts,
             "seconds": time.perf_counter() - t0})
    bf16, kernels = torch.bfloat16, []
    for case in cs.CH_ATTENTION:
        for row in (cs.time_flash(torch, ck, case, bf16,
                                  counts["flash_fwd"]["bf16"]),
                    cs.time_flash_bwd(torch, ck, case, bf16,
                                      counts["flash_bwd"]["bf16"])):
            row.update(case=case[0], launches_path="context_hybrid")
            kernels.append(row)
    cs.emit({"kernels": kernels})
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
