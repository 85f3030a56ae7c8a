#!/usr/bin/env python3
"""The elastic path of ``chip_smoke.py`` alone, on one NVIDIA card.

Run from the root of a checkout on a machine with one card:

    PYTHONPATH=. python3 scripts/chip_elastic.py

It builds the kernels, holds K2 and K3 at the path's shapes (a world-2
trainer's [8, 1024, 12, 64] and the world-1 trainer's [16, 1024, 12, 64],
causal bf16) against their plain versions, drives
``chip_smoke.phase_elastic`` with the launch counts set to 0 just before it
(two elastic agents, the planted local failure and its restart, node 1
killed and the scale-in to world 1, each gate of the path), prints the
counts, then times K2 and K3 at the world-2 trainer's shape beside their
bounds, plain versions and ``scaled_dot_product_attention``. Each phase
prints one JSON line; any failure raises. Without a card it exits 2.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

EL_ATTENTION = [("elastic_world2_rank", 8, 1024, 1024, 12, 12, 64, True),
                ("elastic_world1_rank", 16, 1024, 1024, 12, 12, 64, True)]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_elastic: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_environment(torch, ck)
    rows = [cs.flash_fwd_case(torch, ck, *case, torch.bfloat16)
            for case in EL_ATTENTION]
    rows += [cs.flash_bwd_case(torch, ck, *case, torch.bfloat16)
             for case in EL_ATTENTION]
    cs.hold_bf16_to_library(rows)
    cs.emit({"phase": "elastic_kernels_vs_plain", "cases": rows})
    bad = [r for r in rows if not r["pass"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    cs.phase_elastic(torch, ck, smi)
    counts = {k.name: dict(k.route_launches) for k in ck.KERNELS}
    cs.emit({"phase": "elastic_path_launches", "launches": counts,
             "seconds": time.perf_counter() - t0})
    for name in ("flash_fwd", "flash_bwd"):
        if not counts[name]["bf16"]:
            raise AssertionError(f"{name} never launched on the path")
    case = EL_ATTENTION[0]
    kernels = [cs.time_flash(torch, ck, case, torch.bfloat16,
                             counts["flash_fwd"]["bf16"]),
               cs.time_flash_bwd(torch, ck, case, torch.bfloat16,
                                 counts["flash_bwd"]["bf16"])]
    for row in kernels:
        row.update(case=case[0], launches_path="elastic")
    cs.emit({"kernels": kernels})
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
