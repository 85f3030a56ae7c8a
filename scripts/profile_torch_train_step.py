#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch/CUDA port goes.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 scripts/profile_torch_train_step.py [--workload WORKLOAD]

By default it takes the training workload from
``chip_smoke.gpt124m_training`` (the one ``chip_smoke.py``'s
``training_bf16`` phase times: GPT-124M, batch 16 x 1024 tokens, bf16 O2,
AdamW at lr 1e-4, random weights from seed 0); ``--workload
ernie_pretraining`` and ``--workload bert_finetune`` take
``chip_smoke.ernie_pretraining`` (ERNIE-3.0-base, 16 x 512) and
``chip_smoke.bert_finetune`` (BERT-base, 32 x 128) instead, as
``ernie_pretraining_bf16`` and ``bert_finetune_bf16`` time them;
``--workload packed_attention`` takes ``chip_smoke.packed_attention``
instead (one ``flash_attn_unpadded`` forward and backward over 16,384
packed tokens, 12 heads of 64, causal, bf16, as ``packed_attention_bf16``
times it); ``--workload resnet50`` takes ``chip_smoke.resnet50_training``
(ResNet-50, batch 256 x 3 x 224 x 224, O2, Momentum at lr 0.1, as
``resnet50_training_bf16`` times it), whose kernels it groups as cuDNN's
convolution forward, data-gradient and weight-gradient passes, layout
transforms, batch norm, pools, other GEMMs and the rest, and whose
Momentum update and loss it also reads by the kernels launched under a
named range. It
warms up as that phase does, then traces three steps with
``torch.profiler`` (CPU and CUDA activities). It prints one JSON line:
the traced window's wall time, the device time summed over every kernel
and its share of the window (the rest is the device's idle share), the
device time by group (the hand-written flash and varlen kernels, pass by
pass, cuBLAS GEMMs, everything else) and the fifteen kernels that took
longest. The card's name and power limit come first, as ``nvidia-smi``
reports them. Without a card it exits 2; if the trace holds no device
time it exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (PACKED_WARMUP, TRAIN_WARMUP,  # noqa: E402
                        bert_finetune, ernie_pretraining, gpt124m_training,
                        packed_attention, resnet50_training)

STEPS = 3

GROUPS = (("flash_fwd (K2)", ("flash_fwd_kernel",)),
          ("flash_bwd dk/dv pass (K3)", ("flash_bwd_dkdv_kernel",)),
          ("flash_bwd dq pass (K3)", ("flash_bwd_dq_kernel",)),
          ("flash_varlen_fwd (K4)", ("flash_varlen_fwd_kernel",)),
          ("flash_varlen_bwd dk/dv pass (K5)",
           ("flash_varlen_bwd_dkdv_kernel",)),
          ("flash_varlen_bwd dq pass (K5)", ("flash_varlen_bwd_dq_kernel",)),
          ("cuBLAS GEMM", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")))


# the vision workload's groups, tried in order: cuDNN names its
# convolution kernels by pass (fprop, dgrad, wgrad)
VISION_GROUPS = (("conv dgrad (cuDNN)", ("dgrad",)),
                 ("conv wgrad (cuDNN)", ("wgrad",)),
                 ("conv forward (cuDNN)", ("fprop", "convolve")),
                 ("layout transforms", ("nchwtonhwc", "nhwctonchw",
                                        "transpose")),
                 ("batch norm", ("bn_", "batch_norm", "batchnorm",
                                 "welford")),
                 ("pools", ("pool",)),
                 ("other GEMMs (1x1 convolutions, fc)",
                  ("gemm", "nvjet", "xmma", "cutlass", "sm90_")))
RANGES = ("optimizer update (Momentum)", "loss forward")


def group_of(name, groups=GROUPS):
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    if groups is VISION_GROUPS:
        return "other (elementwise: ReLU, adds, casts, Momentum, loss)"
    return ("other (elementwise, norms, softmax/loss, optimizer, the "
            "varlen plan)")


def training_step(build):
    """A workload maker for one of ``chip_smoke``'s training workloads:
    ``build(torch)`` gives (model, step, batch); the maker returns (step,
    warm-up count)."""
    def make(torch):
        _, step, batch = build(torch)
        ids, labels = batch()
        return (lambda: step(ids, labels)), TRAIN_WARMUP
    return make


def packed_attention_step(torch):
    """(step, warm-up count) of ``chip_smoke``'s packed-attention
    workload: one forward and backward, as its bf16 phase runs them."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    lens, q, k, v, do, cu = packed_attention(torch, torch.bfloat16)

    def step():
        out = flash_attn_unpadded(q, k, v, cu, cu, max(lens), max(lens),
                                  causal=True)[0]
        return torch.autograd.grad(out, (q, k, v), do)

    return step, PACKED_WARMUP


def resnet50_step(torch):
    """(step, warm-up count) of ``chip_smoke``'s ResNet-50 workload, its
    Momentum update and loss forward each under a named range."""
    from paddle_tpu_torch.nn import CrossEntropyLoss
    _, step, batch = resnet50_training(torch)
    x, y = (t[0] for t in batch(1))
    apply, forward = step.optimizer._apply, CrossEntropyLoss.forward

    def ranged(name, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run

    step.optimizer._apply = ranged(RANGES[0], apply)
    CrossEntropyLoss.forward = ranged(RANGES[1], forward)
    return (lambda: step(x, y)), TRAIN_WARMUP


def range_device_us(torch, prof):
    """Device us of the kernels launched under each of ``RANGES`` (by the
    launching operator's enclosing range)."""
    out = {name: 0.0 for name in RANGES}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or \
                not evt.kernels:
            continue
        up = evt
        while up is not None and up.name not in out:
            up = up.cpu_parent
        if up is not None:
            out[up.name] += sum(k.duration for k in evt.kernels)
    return out


WORKLOADS = {"training": training_step(gpt124m_training),
             "ernie_pretraining": training_step(ernie_pretraining),
             "bert_finetune": training_step(bert_finetune),
             "packed_attention": packed_attention_step,
             "resnet50": resnet50_step}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", choices=sorted(WORKLOADS),
                        default="training")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train_step: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    step, warmup = WORKLOADS[args.workload](torch)
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # kernel rows only: the operator rows above them carry the same
    # device time again
    by_name = {}
    for avg in prof.key_averages():
        us = avg.self_device_time_total
        if us > 0 and avg.device_type == torch.autograd.DeviceType.CUDA:
            by_name[avg.key] = by_name.get(avg.key, 0.0) + us
    device_us = sum(by_name.values())
    if device_us == 0:
        print("profile_torch_train_step: the trace holds no device time",
              file=sys.stderr)
        return 1
    vision = args.workload == "resnet50"
    groups = {}
    for name, us in by_name.items():
        g = group_of(name, VISION_GROUPS if vision else GROUPS)
        groups[g] = groups.get(g, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    extra = {}
    if vision:
        ranges = range_device_us(torch, prof)
        extra["per_step_device_ms_by_range"] = {
            n: us / 1e3 / STEPS if us else "not measured"
            for n, us in ranges.items()}
    print(json.dumps({
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "workload": args.workload, "steps": STEPS,
        "window_wall_ms": wall_us / 1e3,
        "device_busy_ms": device_us / 1e3,
        "device_busy_share": device_us / wall_us,
        "per_step_device_ms": {g: us / 1e3 / STEPS
                               for g, us in sorted(groups.items(),
                                                   key=lambda kv: -kv[1])},
        **extra,
        "top_kernels_ms_per_step": [[n[:120], us / 1e3 / STEPS]
                                    for n, us in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
