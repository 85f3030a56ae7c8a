"""The port's elastic relaunch, preemption checkpoint, failure detector,
launcher flags and rendezvous (``paddle_tpu_torch/distributed/elastic/``,
``launch/main.py``), held to the reference:

- every case of ``tests/test_elastic.py`` run against the port (the
  relaunch with restore, the restart budget, the checkpoint lifecycle, one
  and two SIGTERMs, the ``FailureDetector`` over real processes killed,
  resurrected and zombied, the launcher's ``--elastic``);
- the launcher's elastic argument errors exit with the reference's codes
  and messages;
- the rendezvous: a reference ``ElasticRendezvous`` node and a port node
  close one generation on one store with the same world and slots, and
  the store then holds the keys and values of an all-reference round;
  bumps and the min/max-nnodes close agree too.

Trainer processes import the port only.
"""
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from paddle_tpu_torch.distributed.elastic import (checkpoint_path,
                                                  elastic_launch,
                                                  gc_checkpoints,
                                                  latest_checkpoint,
                                                  mark_complete)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# crashes until a checkpoint >= step 2 exists; a trainer that dies mid-run
# and resumes
_WORKER = """
import os, sys
sys.path.insert(0, %(root)r)
from paddle_tpu_torch.distributed.elastic import (checkpoint_path,
                                                  mark_complete,
                                                  latest_checkpoint,
                                                  restart_count)

ckpt = latest_checkpoint()
start = 0 if ckpt is None else int(ckpt.rsplit("_", 1)[1]) + 1
for step in range(start, 4):
    p = checkpoint_path(step)
    os.makedirs(p, exist_ok=True)
    with open(os.path.join(p, "state.txt"), "w") as f:
        f.write(str(step))
    mark_complete(p)
    if step == 1 and restart_count() == 0:
        sys.exit(13)
print(f"finished from step {start} after {restart_count()} restarts",
      flush=True)
""" % {"root": ROOT}


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT, **kw)
    return env


def test_relaunch_restores_from_checkpoint(tmp_path, monkeypatch):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    ckpt_dir = str(tmp_path / "ckpts")
    monkeypatch.setenv("PYTHONPATH", ROOT)
    monkeypatch.setenv("PADDLE_ELASTIC_CKPT_DIR", ckpt_dir)
    rc = elastic_launch([sys.executable, str(worker)], nranks=1,
                        max_restarts=2, ckpt_dir=ckpt_dir,
                        log_dir=str(tmp_path / "logs"), min_backoff=0.05)
    assert rc == 0
    last = latest_checkpoint(ckpt_dir)
    assert last is not None and last.endswith("step_3")
    log = (tmp_path / "logs" / "restart_1" / "workerlog.0").read_text()
    assert "finished from step 2 after 1 restarts" in log


def test_gives_up_after_max_restarts(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text("import sys; sys.exit(7)\n")
    rc = elastic_launch([sys.executable, str(worker)], nranks=1,
                        max_restarts=1, ckpt_dir=str(tmp_path / "c"),
                        min_backoff=0.05)
    assert rc == 7


def test_incomplete_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    p0 = checkpoint_path(0, d)
    os.makedirs(p0)
    mark_complete(p0)
    p1 = checkpoint_path(1, d)
    os.makedirs(p1)  # no .done marker: a crash mid-save
    assert latest_checkpoint(d) == p0


_SIGTERM_WORKER = """
import os, sys, time
sys.path.insert(0, %(root)r)
from paddle_tpu_torch.distributed.elastic import enable_preemption_checkpoint

def save():
    with open(os.environ["OUT_FILE"], "w") as f:
        f.write("checkpointed-at-preemption")

enable_preemption_checkpoint(save, exit_code=0)
print("ready", flush=True)
time.sleep(30)
""" % {"root": ROOT}


def test_sigterm_triggers_checkpoint(tmp_path):
    worker = tmp_path / "w.py"
    worker.write_text(_SIGTERM_WORKER)
    out_file = str(tmp_path / "saved.txt")
    proc = subprocess.Popen([sys.executable, str(worker)],
                            env=_env(OUT_FILE=out_file),
                            stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == "ready"
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=20) == 0
    with open(out_file) as f:
        assert f.read() == "checkpointed-at-preemption"


_BLOCKING_SIGTERM_WORKER = """
import os, sys, time
sys.path.insert(0, %(root)r)
from paddle_tpu_torch.distributed.elastic import enable_preemption_checkpoint

def save():  # a save wedged mid-checkpoint
    open(os.environ["OUT_FILE"], "w").write("entered")
    while True:
        time.sleep(0.1)

enable_preemption_checkpoint(save, exit_code=0)
print("ready", flush=True)
time.sleep(60)
""" % {"root": ROOT}


def test_second_sigterm_forces_exit(tmp_path):
    """The handler restores the previous disposition on entry, so a second
    SIGTERM while the save is wedged ends the process."""
    worker = tmp_path / "w.py"
    worker.write_text(_BLOCKING_SIGTERM_WORKER)
    out_file = str(tmp_path / "saved.txt")
    proc = subprocess.Popen([sys.executable, str(worker)],
                            env=_env(OUT_FILE=out_file),
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 10
        while not os.path.exists(out_file):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        time.sleep(0.2)
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == -signal.SIGTERM
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_gc_checkpoints_keep_last_k(tmp_path):
    d = str(tmp_path)
    for step in range(6):
        p = checkpoint_path(step, d)
        os.makedirs(p)
        mark_complete(p)
    os.makedirs(checkpoint_path(6, d))   # an in-progress save
    os.makedirs(checkpoint_path(2, d) + "_junk")
    deleted = gc_checkpoints(d, keep_last_k=2)
    assert sorted(os.path.basename(p) for p in deleted) == [
        "step_0", "step_1", "step_2", "step_3"]
    left = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert left == ["step_2_junk", "step_4", "step_5", "step_6"]
    assert latest_checkpoint(d).endswith("step_5")
    gc_checkpoints(d, keep_last_k=0)
    assert latest_checkpoint(d).endswith("step_5")
    os.makedirs(checkpoint_path(3, d))
    assert gc_checkpoints(d, keep_last_k=2) == [checkpoint_path(3, d)]


def test_gc_checkpoints_no_complete_checkpoint_deletes_nothing(tmp_path):
    d = str(tmp_path)
    os.makedirs(checkpoint_path(0, d))
    assert gc_checkpoints(d, keep_last_k=1) == []
    assert os.path.isdir(checkpoint_path(0, d))


def test_mark_complete_env_retention(tmp_path, monkeypatch):
    d = str(tmp_path)
    monkeypatch.setenv("PADDLE_ELASTIC_KEEP_CKPTS", "2")
    for step in range(5):
        p = checkpoint_path(step, d)
        os.makedirs(p)
        mark_complete(p)
    left = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert left == ["step_3", "step_4"]


_HB_WORKER = """
import os, signal, sys, time
sys.path.insert(0, %(root)r)
from paddle_tpu_torch.distributed.store import TCPStore
store = TCPStore(port=int(sys.argv[1]), world_size=2, rank=int(sys.argv[2]))
paused = [False]
signal.signal(signal.SIGUSR1, lambda *a: paused.__setitem__(0, True))
store.heartbeat()  # liveness before announcing readiness
print("beating", flush=True)
while True:
    if not paused[0]:
        store.heartbeat()
    time.sleep(0.1)
""" % {"root": ROOT}


def _spawn_hb_worker(tmp_path, port, rank):
    worker = tmp_path / "hb_worker.py"
    worker.write_text(_HB_WORKER)
    proc = subprocess.Popen([sys.executable, str(worker), str(port),
                             str(rank)], env=_env(),
                            stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == "beating"
    return proc


def _wait_for(pred, timeout=10):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.05)


def test_failure_detector_cross_process_kill_and_resurrect(tmp_path):
    """A peer process SIGKILLed is reported once, with its rank; a
    resurrected peer that dies again is reported again."""
    from paddle_tpu_torch.distributed.elastic import FailureDetector
    from paddle_tpu_torch.distributed.store import TCPStore
    master = TCPStore(is_master=True, world_size=2, rank=0)
    seen = []
    det = FailureDetector(master, interval=0.1, timeout=0.8,
                          on_failure=lambda dead: seen.append(list(dead)))
    w = None
    try:
        det.start()
        w = _spawn_hb_worker(tmp_path, master.port, 1)
        time.sleep(1.2)
        assert seen == []
        w.kill()
        w.wait(timeout=10)
        _wait_for(lambda: seen)
        assert seen == [[1]], seen
        time.sleep(1.0)
        assert seen == [[1]], "re-reported a still-dead rank"
        w = _spawn_hb_worker(tmp_path, master.port, 1)
        time.sleep(1.0)
        assert seen == [[1]]
        w.kill()
        w.wait(timeout=10)
        _wait_for(lambda: len(seen) >= 2)
        assert seen == [[1], [1]], seen
    finally:
        det.stop()
        if w is not None and w.poll() is None:
            w.kill()
            w.wait()
        master.close()


def test_failure_detector_zombie_heartbeat_suppression(tmp_path):
    """A peer alive but silent (SIGUSR1 pauses its beats) is declared dead
    as a clean death is."""
    from paddle_tpu_torch.distributed.elastic import FailureDetector
    from paddle_tpu_torch.distributed.store import TCPStore
    master = TCPStore(is_master=True, world_size=2, rank=0)
    seen = []
    det = FailureDetector(master, interval=0.1, timeout=0.8,
                          on_failure=lambda dead: seen.append(list(dead)))
    w = None
    try:
        det.start()
        w = _spawn_hb_worker(tmp_path, master.port, 1)
        w.send_signal(signal.SIGUSR1)
        _wait_for(lambda: seen)
        assert seen == [[1]], seen
        assert w.poll() is None
    finally:
        det.stop()
        if w is not None and w.poll() is None:
            w.kill()
            w.wait()
        master.close()


def test_failure_detector_pause_and_failed_store():
    """Paused heartbeats stop the beats, not the polling; three store
    errors in a row mark the detector failed instead of killing it
    silently."""
    from paddle_tpu_torch.distributed.elastic import FailureDetector
    from paddle_tpu_torch.distributed.store import TCPStore
    master = TCPStore(is_master=True, world_size=1, rank=0)
    det = FailureDetector(master, interval=0.05, timeout=0.3)
    channel = None
    try:
        det.start()
        det.pause_heartbeats()
        _wait_for(lambda: 0 in master.dead_ranks(0.3), timeout=5)
        assert 0 in master.dead_ranks(0.3)
        det.resume_heartbeats()
        _wait_for(lambda: 0 not in master.dead_ranks(0.3), timeout=5)
        assert 0 not in master.dead_ranks(0.3)
        class Gone:
            rank = 0

            def heartbeat(self):
                raise RuntimeError("connection lost")

            def dead_ranks(self, timeout):
                # the swap may land between a sweep's heartbeat and its
                # poll
                raise RuntimeError("connection lost")

            def close(self):
                pass

            deregister = heartbeat

        # the detector's channel is lost (the live one is closed after the
        # thread stops: a handle closed under a thread's call is freed)
        channel, det._hb_store = det._hb_store, Gone()
        _wait_for(lambda: det.failed, timeout=5)
        assert det.failed and "connection lost" in str(det.last_error)
    finally:
        det.stop(deregister=False)
        if channel is not None:
            channel.close()
        master.close()


def test_launcher_elastic_flag(tmp_path):
    """``--elastic`` relaunches a worker that crashes once."""
    worker = tmp_path / "worker.py"
    worker.write_text(
        "import os, sys\n"
        "if os.environ.get('PADDLE_RESTART_COUNT', '0') == '0':\n"
        "    sys.exit(9)\n"
        "print('recovered', flush=True)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--elastic", "--max_restarts", "2",
         "--log_dir", str(tmp_path / "logs"), str(worker)],
        env=_env(), timeout=120, cwd=ROOT)
    assert proc.returncode == 0
    log = (tmp_path / "logs" / "restart_1" / "workerlog.0").read_text()
    assert "recovered" in log


@pytest.mark.parametrize("argv", [
    [],
    ["--elastic", "--nnodes", "2", "--min_nnodes", "3", "x.py"],
    ["--elastic", "--nnodes", "2", "--min_nnodes", "0", "x.py"],
    ["--elastic", "--nnodes", "2", "x.py"],
    ["--elastic", "--nnodes", "2", "--master", "nohost", "x.py"],
    ["--elastic", "--nnodes", "2", "--master", "h:1,h:x", "x.py"],
    ["--nnodes", "2", "--nproc_per_node", "2", "x.py"],
], ids=["no_script", "min_above_nnodes", "min_zero", "no_master",
        "bad_master", "bad_endpoint_list", "multinode_no_master"])
def test_launcher_argument_errors_match_reference(argv, monkeypatch,
                                                  capsys):
    """Each malformed elastic command line exits with the reference's code
    (2) and message, before anything starts."""
    from paddle_tpu.distributed.launch.main import launch as jlaunch

    from paddle_tpu_torch.distributed.launch.main import launch
    monkeypatch.delenv("PADDLE_MASTER", raising=False)
    results = []
    for fn in (jlaunch, launch):
        monkeypatch.setattr(sys, "argv", ["launch"] + argv)
        with pytest.raises(SystemExit) as e:
            fn()
        err = capsys.readouterr().err
        results.append((e.value.code, err.split(":")[0] if not argv
                        else err.replace("paddle_tpu_torch", "paddle_tpu")))
    assert results[0][0] == 2
    assert results[1] == results[0]


# -- the rendezvous -----------------------------------------------------------
_EL_KEYS = ["__el/gen", "__el/g0/count", "__el/g0/world"] + [
    f"__el/g0/arrival/{s}" for s in range(2)]


def _round(store_pair, names, pod_master="10.0.0.1:7"):
    """Close generation 0 with ``names`` joining in order, each through its
    (rendezvous class, store client); returns {name: RendezvousInfo}."""
    out = {}

    def join(cls, client, name):
        r = cls(client, name, 2, 2, timeout=20, last_call=0.1, poll=0.01,
                pod_master_factory=lambda: pod_master)
        out[name] = r.next_rendezvous()

    threads = []
    for (cls, client), name in zip(store_pair, names):
        t = threading.Thread(target=join, args=(cls, client, name))
        t.start()
        threads.append(t)
        # the next node joins once this one holds its slot: a fixed order
        _wait_for(lambda: client.check(f"__el/g0/arrival/{len(threads) - 1}"),
                  timeout=20)
    for t in threads:
        t.join(timeout=30)
    return out


def _keys(client, names):
    return {k: client.get(k) for k in _EL_KEYS +
            [f"__el/g0/member/{n}" for n in names]}, client.num_keys()


def test_rendezvous_reference_and_port_nodes_share_one_round():
    from paddle_tpu.distributed.elastic.rendezvous import (
        ElasticRendezvous as JRdzv)
    from paddle_tpu.distributed.store import TCPStore as JStore

    from paddle_tpu_torch.distributed.elastic.rendezvous import (
        ElasticRendezvous)
    from paddle_tpu_torch.distributed.store import TCPStore
    names = ["node0", "node1"]
    got = {}
    for label, classes in (("reference", (JRdzv, JRdzv)),
                           ("mixed", (JRdzv, ElasticRendezvous))):
        server = TCPStore(is_master=True, world_size=1)
        try:
            clients = [JStore(port=server.port, world_size=1),
                       (JStore if classes[1] is JRdzv else TCPStore)(
                           port=server.port, world_size=1)]
            infos = _round(list(zip(classes, clients)), names)
            got[label] = ({n: tuple(i) for n, i in infos.items()},
                          _keys(server, names))
            for c in clients:
                c.close()
        finally:
            server.close()
    assert got["mixed"] == got["reference"]
    infos = got["mixed"][0]
    assert infos["node0"] == (0, 0, 2, names, "10.0.0.1:7")
    assert infos["node1"] == (0, 1, 2, names, "10.0.0.1:7")


def test_rendezvous_bump_and_min_nnodes_close():
    """A bump advances the generation once among racers; a round at
    min_nnodes closes after the last call, and a late node that finds it
    closed bumps and the next round takes both."""
    from paddle_tpu_torch.distributed.elastic.rendezvous import (
        ElasticRendezvous)
    from paddle_tpu_torch.distributed.store import TCPStore
    server = TCPStore(is_master=True, world_size=1)
    try:
        a = ElasticRendezvous(server, "a", 1, 2, timeout=20, last_call=0.2,
                              poll=0.01)
        assert a.current_generation() == 0
        assert a.bump_generation(0) == (1, True)
        assert a.bump_generation(0) == (1, False)
        info = a.next_rendezvous()
        assert (info.generation, info.rank, info.nnodes) == (1, 0, 1)
        late = TCPStore(port=server.port, world_size=1)
        b = ElasticRendezvous(late, "b", 1, 2, timeout=20, last_call=0.2,
                              poll=0.01)
        out = {}
        t = threading.Thread(target=lambda: out.update(b=b.next_rendezvous()))
        t.start()
        _wait_for(lambda: b.current_generation() == 2)
        out["a"] = a.next_rendezvous()
        t.join(timeout=30)
        assert {k: (v.generation, v.nnodes) for k, v in out.items()} == \
            {"a": (2, 2), "b": (2, 2)}
        assert sorted(v.rank for v in out.values()) == [0, 1]
        late.close()
        with pytest.raises(ValueError):
            ElasticRendezvous(server, "c", 3, 2)
    finally:
        server.close()
