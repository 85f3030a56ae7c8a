"""``python -m paddle_tpu_torch.distributed.launch`` (counterpart:
``paddle_tpu/distributed/launch/main.py``; upstream's launcher):

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \
        [--nnodes M --rank R --master HOST:PORT --log_dir DIR] \
        [--elastic [--min_nnodes M] [--max_restarts K] [--host_store]] \
        script.py [args]

starts one fresh interpreter per rank of this node (never a fork), each
with the reference's env contract (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``, and ``PADDLE_LOCAL_RANK`` /
``PADDLE_LOCAL_SIZE`` for the rank's card), sends each rank's output to
``<log_dir>/workerlog.<rank>`` (to this process's own output without
``--log_dir``), and watches the ranks: when one exits non-zero the others
get SIGTERM, then SIGKILL after a grace period, and the launcher exits
with that rank's code.

``--elastic`` on one node (no ``--min_nnodes``) reruns the pod through
``elastic.ElasticManager`` up to ``--max_restarts`` times, with
``PADDLE_RESTART_COUNT`` raised each time. With ``--nnodes`` above 1 or
``--min_nnodes`` it runs this node's ``elastic.agent.ElasticAgent``: the
agents rendezvous through the ``TCPStore`` at ``--master`` (hosted by the
agent given ``--host_store``, or by ``python -m
paddle_tpu_torch.distributed.elastic.agent --serve_store``; a comma list of
endpoints names a replicated store), recompute the world on scale-in and
scale-out and restart the trainers from the latest checkpoint. With
``--min_nnodes`` and no ``--master`` the agent hosts the store on a free
local port. A bad ``--min_nnodes`` or ``--master`` exits 2.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from ...observability import flight as _obs_flight
from ..env import find_free_port


def _parse(argv):
    opts = {"nnodes": 1, "nproc_per_node": 1, "rank": None,
            "master": os.environ.get("PADDLE_MASTER", ""),
            "log_dir": None, "script": [], "elastic": False,
            "max_restarts": 3, "min_nnodes": None, "host_store": False}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--nnodes":
            opts["nnodes"] = int(argv[i + 1]); i += 2
        elif a == "--nproc_per_node":
            opts["nproc_per_node"] = int(argv[i + 1]); i += 2
        elif a == "--master":
            opts["master"] = argv[i + 1]; i += 2
        elif a == "--rank":
            opts["rank"] = int(argv[i + 1]); i += 2
        elif a == "--log_dir":
            opts["log_dir"] = argv[i + 1]; i += 2
        elif a == "--elastic":
            opts["elastic"] = True; i += 1
        elif a == "--max_restarts":
            opts["max_restarts"] = int(argv[i + 1]); i += 2
        elif a == "--min_nnodes":
            opts["min_nnodes"] = int(argv[i + 1]); i += 2
        elif a == "--host_store":
            opts["host_store"] = True; i += 1
        elif a in ("--devices", "--gpus", "--xpus"):
            i += 2   # accepted for compatibility: rank k takes card k
        else:
            opts["script"] = argv[i:]
            break
    return opts


def _rank_env(base, rank, world, master, local_rank=None, local_size=None):
    env = dict(base)
    env["PADDLE_TRAINER_ID"] = str(rank)
    env["PADDLE_TRAINERS_NUM"] = str(world)
    env["PADDLE_LOCAL_RANK"] = str(rank if local_rank is None
                                   else local_rank)
    env["PADDLE_LOCAL_SIZE"] = str(world if local_size is None
                                   else local_size)
    if master:
        env["PADDLE_MASTER"] = master
    return env


def run_pod(cmd, ranks, world, master, log_dir=None, base_env=None,
            stop=None, grace=10.0, extra_env=None):
    """Start one process per rank in ``ranks``, watch them, and tear the
    rest down when one fails: SIGTERM, then SIGKILL past ``grace``
    seconds. ``stop`` (a ``threading.Event``) asks for a teardown from
    outside; ranks that die in it do not count as failures. Returns the
    pod's exit code: 0 when every rank exited 0, else the first failed
    rank's code."""
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    ranks = list(ranks)
    procs, logs = [], []
    rank_of = {}
    try:
        for local, r in enumerate(ranks):
            out = None
            if log_dir is not None:
                out = open(os.path.join(log_dir, f"workerlog.{r}"), "w")
                logs.append(out)
            env = _rank_env(base_env or os.environ, r, world, master,
                            local, len(ranks))
            if extra_env:
                env.update(extra_env)
            p = subprocess.Popen(cmd, env=env, stdout=out,
                                 stderr=subprocess.STDOUT if out else None)
            procs.append(p)
            rank_of[id(p)] = r
        rc = 0
        tearing_down = False
        kill_deadline = None
        alive = list(procs)
        while alive:
            if stop is not None and stop.is_set() and not tearing_down:
                tearing_down = True
                kill_deadline = time.monotonic() + grace
                _terminate(procs, rank_of, "external stop")
            still = []
            for p in alive:
                ret = p.poll()
                if ret is None:
                    still.append(p)
                elif ret != 0 and rc == 0 and not tearing_down:
                    rc = ret
            if rc != 0 and not tearing_down:
                tearing_down = True
                kill_deadline = time.monotonic() + grace
                _terminate(procs, rank_of, f"rank failed rc={rc}")
            if tearing_down and still and time.monotonic() >= kill_deadline:
                for q in still:
                    q.kill()
            alive = still
            if alive:
                time.sleep(0.05)
        return rc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def _terminate(procs, rank_of, why):
    dying = [rank_of[id(q)] for q in procs if q.poll() is None]
    for q in procs:
        if q.poll() is None:
            q.send_signal(signal.SIGTERM)
    _obs_flight.record("teardown", "pod.teardown", why=why, ranks=dying)
    print(f"launch: tearing down ranks {dying} ({why})", file=sys.stderr,
          flush=True)


def launch():
    """The launcher's command line (see the module docstring)."""
    opts = _parse(sys.argv[1:])
    if not opts["script"]:
        print("usage: python -m paddle_tpu_torch.distributed.launch "
              "[--nnodes N --nproc_per_node P --master H:P --rank R "
              "--log_dir D] [--elastic --min_nnodes M --max_restarts K "
              "--host_store] script.py [args]", file=sys.stderr)
        sys.exit(2)
    nnodes, nproc = opts["nnodes"], opts["nproc_per_node"]
    world = nnodes * nproc
    master = opts["master"]
    elastic_multinode = opts["elastic"] and (
        nnodes > 1 or opts["min_nnodes"] is not None)
    if opts["min_nnodes"] is not None and not \
            (1 <= opts["min_nnodes"] <= nnodes):
        print(f"--min_nnodes must satisfy 1 <= M <= nnodes "
              f"(got M={opts['min_nnodes']}, nnodes={nnodes})",
              file=sys.stderr)
        sys.exit(2)
    if elastic_multinode and not master:
        if nnodes > 1:
            print("--master host:port is required for multi-node launch",
                  file=sys.stderr)
            sys.exit(2)
        # one elastic node with --min_nnodes: host the membership store
        # here, on a port decided before the fallback below takes one
        master = f"127.0.0.1:{find_free_port()}"
        opts["host_store"] = True
    if world > 1 and not master:
        if nnodes > 1:
            print("--master host:port is required for multi-node launch",
                  file=sys.stderr)
            sys.exit(2)
        master = f"127.0.0.1:{find_free_port()}"
    node_rank = opts["rank"]
    if node_rank is None:
        node_rank = int(os.environ.get(
            "PADDLE_NODE_RANK", os.environ.get("PADDLE_TRAINER_ID", "0")))
    ranks = range(node_rank * nproc, node_rank * nproc + nproc)
    cmd = [sys.executable] + opts["script"]
    if elastic_multinode:
        from ..elastic.agent import ElasticAgent
        from ..store_ha import parse_endpoints
        try:
            endpoints = parse_endpoints(master)
        except ValueError as e:
            print(f"--master must be host:port[,host:port...] "
                  f"(got {master!r}: {e})", file=sys.stderr)
            sys.exit(2)
        host, port = endpoints[0]
        sys.exit(ElasticAgent(
            cmd, nproc_per_node=nproc,
            store_host=host or "127.0.0.1", store_port=port,
            nnodes=nnodes, min_nnodes=opts["min_nnodes"] or nnodes,
            max_restarts=opts["max_restarts"],
            log_dir=opts["log_dir"],
            host_store=opts["host_store"],
            store_endpoints=endpoints if len(endpoints) > 1 else None)
            .run())
    if opts["elastic"]:
        from ..elastic import ElasticManager
        sys.exit(ElasticManager(max_restarts=opts["max_restarts"]).run(
            cmd, nranks=nproc, master=master or None,
            log_dir=opts["log_dir"]))
    sys.exit(run_pod(cmd, ranks, world, master, log_dir=opts["log_dir"]))


if __name__ == "__main__":
    launch()
