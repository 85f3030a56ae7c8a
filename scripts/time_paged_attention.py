#!/usr/bin/env python3
"""Time K1, the port's paged attention kernel, at the shapes ``chip_smoke.py``
times it, for one checkout of the port or several in turns.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 scripts/time_paged_attention.py [--port DIR ...]

Each ``--port`` names the root of a checkout whose ``paddle_tpu_torch`` is
timed (default: this checkout). Each checkout runs in a process of its own,
in the order given, so ``--port A --port B --port B --port A`` compares two
versions in turns on one card. Each shape is timed by this checkout's
``chip_smoke.time_paged``, so every version sees the same inputs and the
same timing: bf16, h 12, d 64, page 16, at serving's contexts with KQ = 1 and
KQ = 5 and at the bytes-heavy shape (64 slots of 1024 tokens). Each process
prints one JSON line with the card's name and power limit as ``nvidia-smi``
reports them. Without a card it exits 2.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_one(port):
    """Time the ``paddle_tpu_torch`` under ``port`` in this process."""
    import torch
    sys.path.insert(0, os.path.abspath(port))
    from paddle_tpu_torch.ops import cuda_kernels as ck
    cs = _chip_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rows = [cs.time_paged(torch, ck, ctxs, kq, torch.bfloat16, None, label)
            for label, ctxs, kq in (("serving", cs.PAGED_CTXS[1], 1),
                                    ("serving_verify", cs.PAGED_CTXS[5], 5),
                                    ("bytes_heavy", cs.PAGED_BYTES_CTXS, 1))]
    print(json.dumps({"port": os.path.abspath(port), "nvidia_smi": smi,
                      "device": torch.cuda.get_device_name(0),
                      "paged_attention": rows}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", action="append",
                    help="root of a checkout to time (repeatable)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_paged_attention: no CUDA card", file=sys.stderr)
        return 2
    if args.one:
        time_one(args.one)
        return 0
    for port in args.port or [ROOT]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        port], check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
