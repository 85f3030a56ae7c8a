#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s eager fp16 AMP path (GPT-124M at 16 x 1024,
``phase_gpt124m_fp16_amp``: 3 warm-up and 10 timed steps) for each
checkout root given, each in its own process, in the order given; prints
one JSON line per run with the root, tokens/s and the card.

    python3 scripts/ab_eager_amp.py --root A --root B --root B --root A

For an A/B of two commits, unpack the parent with ``git archive`` into a
git-ignored directory of the checkout and pass parent, change, change,
parent: the card and its host are shared by all four runs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from paddle_tpu_torch.ops import cuda_kernels as ck
out = []
cs.emit = out.append
smi = cs.phase_environment(torch, ck)
cs.phase_gpt124m_fp16_amp(torch, ck, smi)
row = out[-1]
print(json.dumps({"root": sys.argv[1], "tokens_per_s": row["tokens_per_s"],
                  "step_ms": row["step_ms"], "nvidia_smi": smi}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", required=True)
    args = ap.parse_args()
    for root in args.root:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _CHILD, root],
                              cwd=root, capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
