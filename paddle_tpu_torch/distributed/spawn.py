"""``paddle.distributed.spawn`` (counterpart: ``paddle_tpu/distributed/
spawn.py``): ``func(*args)`` in ``nprocs`` fresh interpreters (the
``spawn`` start method, never a fork of a process that may hold a CUDA
context), each with the rank env set before ``func`` runs, so that
``init_parallel_env`` inside ``func`` joins the same world it would under
the launcher. ``backend=`` sets ``PADDLE_DISTRI_BACKEND`` in the ranks;
``nprocs=-1`` starts one rank per card."""
from __future__ import annotations

import multiprocessing as mp
import os

import torch

from .env import BACKEND_ENV, find_free_port


def _worker(func, args, rank, nprocs, master, env):
    os.environ.update(env)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    os.environ["PADDLE_LOCAL_RANK"] = str(rank)
    os.environ["PADDLE_LOCAL_SIZE"] = str(nprocs)
    os.environ["PADDLE_MASTER"] = master
    func(*args)


class SpawnContext:
    def __init__(self, procs):
        self.processes = procs

    def join(self, timeout=None):
        """Wait for the ranks (each up to ``timeout`` seconds); a rank that
        failed raises RuntimeError after the others are stopped. Returns
        True when every rank has exited."""
        for p in self.processes:
            p.join(timeout)
            if p.exitcode not in (0, None):
                break
        bad = [p for p in self.processes if p.exitcode not in (0, None)]
        if bad:
            for p in self.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
            raise RuntimeError(
                f"spawned rank(s) {[p.name for p in bad]} failed with "
                f"exit codes {[p.exitcode for p in bad]}")
        return all(p.exitcode is not None for p in self.processes)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Run ``func(*args)`` in ``nprocs`` processes; returns a
    ``SpawnContext`` (``join=False``) or None after joining. Options:
    ``backend`` ("nccl" or "gloo"), ``master`` ("host:port"),
    ``timeout`` (seconds for the join)."""
    if nprocs == -1:
        nprocs = max(torch.cuda.device_count(), 1)
    master = options.get("master") or f"127.0.0.1:{find_free_port()}"
    env = {}
    if options.get("backend"):
        env[BACKEND_ENV] = options["backend"]
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, args, rank, nprocs, master, env),
                        daemon=daemon, name=f"rank{rank}")
        p.start()
        procs.append(p)
    context = SpawnContext(procs)
    if join:
        context.join(options.get("timeout"))
        return None
    return context
