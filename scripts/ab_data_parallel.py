#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s data-parallel GPT-124M step (two gloo ranks
sharing the card, ``dp_gpt124m_rank``: 3 warm-up and 5 timed steps of
8 x 1024 a rank, the model in ``paddle.DataParallel``) for each checkout
root given, each under the port's launcher, in the order given. Prints one
JSON line per run: the root, each rank's step ms and comm plane stats,
the step with no gradient sync and the buckets' all-reduce alone (where
that root's ``chip_smoke.py`` times them), rank 0's timeline of the last
step (each bucket's launch and landing, in ms from the end of its
backward) and the card.

    python3 scripts/ab_data_parallel.py --root A --root B --root B --root A

For an A/B of two trees, unpack the other with ``git archive`` into a
git-ignored directory of the checkout and pass A, B, B, A: the card and
its host are shared by all four runs.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

TIMEOUT_S = 600


def rank_main(root):
    """One rank: ``dp_gpt124m_rank`` of ``root``'s ``chip_smoke.py`` with
    the comm plane's launches and landings and the end of each backward
    stamped on the host clock."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import comm_plane, parallel
    from paddle_tpu_torch.ops import cuda_kernels as ck
    env = dist.init_parallel_env()
    log = []

    end_of_backward = parallel.DataParallel._end_of_backward

    def stamped_end_of_backward(self):
        log.append(("end_of_backward", None, time.monotonic()))
        end_of_backward(self)

    parallel.DataParallel._end_of_backward = stamped_end_of_backward
    plane = comm_plane.CommPlane
    if hasattr(plane, "launch"):        # backend works (async_op=True)
        launch, landed = plane.launch, comm_plane.CollectiveWork._landed

        def stamped_launch(self, start, then=None, label="collective",
                           **kw):
            log.append(("launch", label, time.monotonic()))
            return launch(self, start, then, label, **kw)

        def stamped_landed(self, fut):
            log.append(("land", self.label, time.monotonic()))
            return landed(self, fut)

        plane.launch = stamped_launch
        comm_plane.CollectiveWork._landed = stamped_landed
    else:                               # a comm thread running submit()s
        submit = plane.submit

        def stamped_submit(self, fn, label="collective", **kw):
            log.append(("launch", label, time.monotonic()))

            def run():
                try:
                    return fn()
                finally:
                    log.append(("land", label, time.monotonic()))
            return submit(self, run, label=label, **kw)

        plane.submit = stamped_submit
    out = chip_smoke.dp_gpt124m_rank(torch, ck, dist, env.rank,
                                     env.world_size)
    ends = [i for i, row in enumerate(log) if row[0] == "end_of_backward"]
    first = ends[-2] + 1 if len(ends) > 1 else 0
    t_end = log[ends[-1]][2]
    timeline = [(kind, label, (t - t_end) * 1e3)
                for kind, label, t in log[first:]
                if label is None or str(label).startswith("dp.")]
    print(json.dumps({"rank": env.rank, "step_ms": out["step_ms"],
                      "comm_plane": out["comm_plane"],
                      "local_step_ms_each": out.get("local_step_ms_each"),
                      "allreduce_alone_ms_each":
                          out.get("allreduce_alone_ms_each"),
                      "timeline": timeline}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_root(root, smi):
    log_dir = tempfile.mkdtemp(prefix="ab_dp_")
    env = dict(os.environ, PYTHONPATH=root, PADDLE_DISTRI_BACKEND="gloo")
    env.pop("PADDLE_MASTER", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", log_dir,
         os.path.abspath(__file__), "--rank-of", root],
        cwd=root, env=env, start_new_session=True)
    try:
        proc.wait(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None or proc.returncode != 0:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    ranks = []
    for r in range(2):
        text = open(os.path.join(log_dir, f"workerlog.{r}")).read()
        if proc.returncode:
            sys.stderr.write(text[-4000:])
        rows = [json.loads(line) for line in text.splitlines()
                if line.startswith('{"rank"')]
        ranks.extend(rows[-1:])
    if proc.returncode or len(ranks) != 2:
        raise SystemExit(f"{root}: the ranks failed (rc {proc.returncode})")
    timeline = ranks[0].pop("timeline")
    for row in ranks[1:]:
        row.pop("timeline")
    return {"root": root, "ranks": ranks, "timeline_rank0": timeline,
            "nvidia_smi": smi}


def main():
    if sys.argv[1:2] == ["--rank-of"]:
        return rank_main(sys.argv[2])
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", required=True)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for root in args.root:
        print(json.dumps(run_root(os.path.abspath(root), smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
