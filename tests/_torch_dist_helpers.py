"""Shared pieces of the port's multi-process tests: running a worker
script under the port's launcher (``python -m paddle_tpu_torch.
distributed.launch``) over gloo on the CPU, and functions ``spawn``
starts (a spawned rank imports its function by module path, so this
module imports only the port)."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rank_env(extra=None):
    """The env a rank runs in: the repo on the path, one torch thread,
    JAX (for reference workers) on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env.pop("PADDLE_MASTER", None)
    env.update(extra or {})
    return env


def launch(tmp_path, script, nproc=2, timeout=120, module=(
        "paddle_tpu_torch.distributed.launch"), extra_env=None, args=()):
    """Write ``script`` to ``tmp_path`` and run it on ``nproc`` ranks
    under the launcher ``module``; returns (completed process,
    {workerlog name: text})."""
    worker = Path(tmp_path) / "worker.py"
    worker.write_text(script)
    log_dir = Path(tmp_path) / "logs"
    proc = subprocess.run(
        [sys.executable, "-m", module, "--nproc_per_node", str(nproc),
         "--log_dir", str(log_dir), str(worker), *args],
        env=rank_env(extra_env), timeout=timeout, capture_output=True,
        text=True, cwd=str(ROOT))
    logs = {p.name: p.read_text() for p in log_dir.glob("workerlog.*")}
    return proc, logs


def assert_ranks_ok(proc, logs, nproc=2, mark="ok"):
    assert proc.returncode == 0, (proc.stdout, proc.stderr, logs)
    for r in range(nproc):
        assert f"rank{r} {mark}" in logs.get(f"workerlog.{r}", ""), logs


def spawn_all_reduce(out_dir):
    """A ``spawn`` target: SUM-reduce the rank's id + 1 and write the
    result and the env contract to ``out_dir/rank<r>.txt``."""
    import torch

    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env(device="cpu")
    r = dist.get_rank()
    t = torch.tensor([float(r + 1)])
    dist.all_reduce(t)
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
            "PADDLE_DISTRI_BACKEND")
    Path(out_dir, f"rank{r}.txt").write_text(
        repr((float(t), dist.get_backend(), [os.environ.get(k)
                                              for k in keys])))


def spawn_fail_rank1():
    import paddle_tpu_torch.distributed as dist
    if int(os.environ["PADDLE_TRAINER_ID"]) == 1:
        raise SystemExit(3)
    dist.get_rank()
