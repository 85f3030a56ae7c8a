#!/usr/bin/env python3
"""The jit_inference path of ``chip_smoke.py`` alone, on one NVIDIA card.

Run from the root of a checkout on a machine with one card:

    PYTHONPATH=. python3 scripts/chip_jit.py

It builds the kernels, holds K2 and K3 at the path's shapes
(``chip_smoke.JIT_ATTENTION``: a predictor request [8, 1024] and the fp32
gates' [2, 1024]) against their plain versions in bf16 and fp32, drives
``chip_smoke.phase_jit_inference`` with the launch counts set to 0 just
before it (``to_static`` against the eager port, ``jit.save`` and the
predictor's 20 requests, the CPU-saved program on the card,
``Model.save(training=False)``, the static Executor), prints the counts,
then times K2 at a request's shape and K2 and K3 at the fp32 gates' shape
beside their bounds, plain versions and ``scaled_dot_product_attention``,
and K2 and K3 called straight against their ``torch.library`` ops.
Each phase prints one JSON line; any failure raises. Without a card it
exits 2.
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
        print("chip_jit: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_environment(torch, ck)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        got = [cs.flash_fwd_case(torch, ck, *case, dtype)
               for case in cs.JIT_ATTENTION]
        got += [cs.flash_bwd_case(torch, ck, *case, dtype)
                for case in cs.JIT_ATTENTION]
        if dtype != torch.float32:
            cs.hold_bf16_to_library(got)
        rows += got
    cs.emit({"phase": "jit_kernels_vs_plain", "cases": rows})
    bad = [r for r in rows if not r["pass"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    cs.phase_jit_inference(torch, ck, smi)
    counts = {k.name: dict(k.route_launches) for k in ck.KERNELS}
    cs.emit({"phase": "jit_path_launches", "launches": counts,
             "seconds": time.perf_counter() - t0})
    for name in ("flash_fwd", "flash_bwd"):
        if not sum(counts[name].values()):
            raise AssertionError(f"{name} never launched on the path")
    bf16, f32 = torch.bfloat16, torch.float32
    kernels = [cs.time_flash(torch, ck, cs.JIT_ATTENTION[0], bf16,
                             counts["flash_fwd"]["bf16"]),
               cs.time_flash(torch, ck, cs.JIT_ATTENTION[1], f32,
                             counts["flash_fwd"]["fp32"]),
               cs.time_flash_bwd(torch, ck, cs.JIT_ATTENTION[1], f32,
                                 counts["flash_bwd"]["fp32"])]
    for row, case in zip(kernels, (cs.JIT_ATTENTION[0], cs.JIT_ATTENTION[1],
                                   cs.JIT_ATTENTION[1])):
        row.update(case=case[0], launches_path="jit_inference")
    cs.emit({"phase": "custom_op_cost", "cases": cs._custom_op_cost(torch,
                                                                  ck)})
    cs.emit({"kernels": kernels})
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
