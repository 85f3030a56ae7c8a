"""The fault-injection harness of ``tests/_chaos_helpers.py`` driving the
port: the same pods, store servers and chaos trainers, with every process
started through the port's command lines (``python -m
paddle_tpu_torch.distributed.launch --elastic`` agents, ``python -m
paddle_tpu_torch.distributed.elastic.agent --serve_store`` stores)."""
from __future__ import annotations

import os
import subprocess
import sys

from _chaos_helpers import (REPO, ElasticPod, ReplicatedStoreCluster,
                            StoreServerProc, chaos_env)

PORT_LAUNCH = "paddle_tpu_torch.distributed.launch"
PORT_AGENT = "paddle_tpu_torch.distributed.elastic.agent"


def _serve(extra, env):
    proc = subprocess.Popen(
        [sys.executable, "-m", PORT_AGENT, "--serve_store", "--port", "0"]
        + extra, env=env, cwd=REPO, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    assert line.startswith("STORE_PORT="), line
    return proc, int(line.strip().split("=", 1)[1])


class PortStoreServer(StoreServerProc):
    """The port's ``--serve_store`` process (``stall``/``close`` as the
    reference's)."""

    def __init__(self, env=None):
        self.proc, self.port = _serve([], env or chaos_env("/tmp"))


class PortReplicatedCluster(ReplicatedStoreCluster):
    """A primary and its standbys, each the port's ``--serve_store``."""

    @staticmethod
    def _spawn(extra, env):
        return _serve(extra, env)


class PortPod(ElasticPod):
    """Elastic agents started through the port's launcher."""

    def start_node(self, idx):
        os.makedirs(self.log_root, exist_ok=True)
        out = open(os.path.join(self.log_root, f"agent.{idx}.log"), "w")
        self.agents[idx] = subprocess.Popen(
            [sys.executable, "-m", PORT_LAUNCH,
             "--elastic", "--nnodes", str(self.nnodes),
             "--min_nnodes", str(self.min_nnodes),
             "--nproc_per_node", str(self.nproc),
             "--max_restarts", str(self.max_restarts),
             "--master", self._master,
             "--log_dir", os.path.join(self.log_root, f"node{idx}"),
             self.script] + self.script_args,
            env=self.env, cwd=REPO, stdout=out, stderr=out)
        out.close()
        return self.agents[idx]


# the reference's FULL_TRAINER through the port's checkpoint lifecycle
PORT_FULL_TRAINER = r"""
import json, os, sys, time
sys.path.insert(0, %(repo)r)
from paddle_tpu_torch.distributed.elastic import (checkpoint_path,
                                                  mark_complete,
                                                  latest_checkpoint)
total = int(sys.argv[1]); dt = float(sys.argv[2]); hist_dir = sys.argv[3]
rank = int(os.environ["PADDLE_TRAINER_ID"])
world = int(os.environ["PADDLE_TRAINERS_NUM"])
gen = int(os.environ.get("PADDLE_ELASTIC_GENERATION", "0"))
ckpt = latest_checkpoint()
if ckpt is None:
    start, state = 0, 0
else:
    with open(os.path.join(ckpt, "state.json")) as f:
        d = json.load(f)
    start, state = d["step"] + 1, d["state"]
os.makedirs(hist_dir, exist_ok=True)
hist = os.path.join(hist_dir, f"hist.{os.getpid()}")
for step in range(start, total):
    state += (step + 1) * 7
    time.sleep(dt)
    with open(hist, "a") as f:
        f.write(json.dumps({"step": step, "world": world, "gen": gen,
                            "rank": rank, "ts": time.time()}) + "\n")
        f.flush()
    if rank == 0:
        p = checkpoint_path(step)
        os.makedirs(p, exist_ok=True)
        with open(os.path.join(p, "state.json"), "w") as f:
            json.dump({"step": step, "state": state}, f)
        mark_complete(p)
print(f"DONE state={state}", flush=True)
""" % {"repo": REPO}
