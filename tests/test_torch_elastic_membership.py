"""Store-backed elastic membership end to end on the port, as
``tests/test_elastic_membership.py`` runs it on the reference: real
multi-agent pods on the CPU through the port's launcher
(``tests/_torch_chaos_helpers.py``), faults injected by the reference's
harness (``tests/_chaos_helpers.py``).

Scale-in: a 3-agent pod loses a node to SIGKILL; the survivors detect the
stale heartbeat, bump the generation, rendezvous again at world 2 and
resume from the latest complete checkpoint without consuming the restart
budget. A trainer's own crash consumes it. The trainers' state is a
world-independent accumulator, so the final state must equal a run that
never failed. As in the reference, the 3 -> 2 scale-in and the local
failure are tier-1 and the longer legs (scale-out, the zombie agent, the
wedged node, the store stall) are marked slow."""
import os
import signal
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _chaos_helpers import (  # noqa: E402
    LIGHT_TRAINER, chaos_env, expected_state, read_history,
    wait_for_checkpoint, wait_for_history)
from _torch_chaos_helpers import (PORT_FULL_TRAINER, PortPod,  # noqa: E402
                                  PortStoreServer)


LAST_CALL = 3.0


def _final_state(ckpt_dir, step):
    import json
    with open(os.path.join(str(ckpt_dir), f"step_{step}",
                           "state.json")) as f:
        return json.load(f)["state"]


def _make_pod(tmp_path, trainer_src, total, dt, nnodes=3, min_nnodes=2,
              max_restarts=3):
    script = tmp_path / "trainer.py"
    script.write_text(trainer_src)
    ckpt_dir = tmp_path / "ckpts"
    hist_dir = tmp_path / "hist"
    # a last call longer than the agents' start-up can drift apart under a
    # loaded test run, so the first round forms at the full nnodes
    env = chaos_env(ckpt_dir, PADDLE_ELASTIC_LAST_CALL=LAST_CALL)
    store = PortStoreServer(env=env)
    pod = PortPod(script, nnodes=nnodes, min_nnodes=min_nnodes,
                  store_port=store.port, env=env,
                  log_root=tmp_path / "logs", max_restarts=max_restarts,
                  script_args=[total, dt, hist_dir])
    return store, pod, ckpt_dir, hist_dir


def test_scale_in_3_to_2_resumes_from_checkpoint(tmp_path):
    """SIGKILL one of three nodes mid-training: the survivors re-form at
    world 2 within the heartbeat timeout, resume from the latest complete
    checkpoint, end in the never-failed run's state, and the restart
    budget is untouched."""
    total, dt = 16, 0.25
    store, pod, ckpt_dir, hist_dir = _make_pod(
        tmp_path, LIGHT_TRAINER, total, dt)
    try:
        pod.start_all()
        wait_for_checkpoint(ckpt_dir, 3, timeout=90)
        pod.kill_node(2)
        t_kill = time.monotonic()
        wait_for_history(
            hist_dir, lambda es: any(e["world"] == 2 for e in es),
            timeout=60)
        detect_rdzv_restore = time.monotonic() - t_kill
        rcs = pod.wait(idxs=[0, 1], timeout=120)
        assert rcs == {0: 0, 1: 0}, \
            (rcs, pod.agent_log(0), pod.agent_log(1))
        entries = read_history(hist_dir)
        gens_at_2 = {e["gen"] for e in entries if e["world"] == 2}
        assert gens_at_2, "no steps ran at world_size=2"
        assert min(gens_at_2) >= 1, "world shrank without a generation bump"
        assert {e["step"] for e in entries} == set(range(total))
        assert _final_state(ckpt_dir, total - 1) == expected_state(total)
        logs = pod.agent_log(0) + pod.agent_log(1)
        assert "resume=" in logs and "step_" in logs.split(
            "generation 1", 1)[-1]
        assert "restart 1/" not in logs, logs
        assert detect_rdzv_restore < 45, detect_rdzv_restore
    finally:
        pod.shutdown()
        store.close()


@pytest.mark.slow
def test_scale_out_rejoin_at_next_generation(tmp_path):
    """After a 3 -> 2 scale-in a fresh node joins the running fleet: it
    bumps the generation and the pod re-forms at world 3, ending in the
    exact state (the trainer through the port's checkpoint lifecycle)."""
    total, dt = 60, 0.25
    store, pod, ckpt_dir, hist_dir = _make_pod(
        tmp_path, PORT_FULL_TRAINER, total, dt)
    try:
        pod.start_all()
        wait_for_checkpoint(ckpt_dir, 3, timeout=90)
        pod.kill_node(2)
        wait_for_history(
            hist_dir, lambda es: sum(e["world"] == 2 for e in es) >= 2,
            timeout=60)
        pod.start_node(3)
        wait_for_history(
            hist_dir, lambda es: any(e["world"] == 3 and e["gen"] >= 2
                                     for e in es), timeout=90)
        rcs = pod.wait(idxs=[0, 1, 3], timeout=180)
        assert rcs == {0: 0, 1: 0, 3: 0}, \
            {i: pod.agent_log(i) for i in (0, 1, 3)}
        entries = read_history(hist_dir)
        by_gen_world = {(e["gen"], e["world"]) for e in entries}
        worlds = sorted(w for _, w in by_gen_world)
        assert 2 in worlds and worlds.count(3) >= 2, by_gen_world
        gen_at_2 = min(g for g, w in by_gen_world if w == 2)
        assert any(g > gen_at_2 and w == 3 for g, w in by_gen_world)
        assert {e["step"] for e in entries} == set(range(total))
        assert _final_state(ckpt_dir, total - 1) == expected_state(total)
    finally:
        pod.shutdown()
        store.close()


@pytest.mark.slow
def test_zombie_agent_rejoins_monitored(tmp_path):
    """SIGUSR1 zombies an agent: its peers evict it, it rejoins, and the
    rendezvous resumes its heartbeats, so its later real death is
    detected again."""
    total, dt = 70, 0.25
    store, pod, ckpt_dir, hist_dir = _make_pod(
        tmp_path, LIGHT_TRAINER, total, dt)
    try:
        pod.start_all()
        wait_for_checkpoint(ckpt_dir, 3, timeout=90)
        pod.suppress_heartbeats(2)
        entries = wait_for_history(
            hist_dir, lambda es: any(e["world"] == 3 and e["gen"] >= 1
                                     for e in es), timeout=90)
        gen_rejoined = max(e["gen"] for e in entries if e["world"] == 3)
        pre_kill = max(e["step"] for e in entries)
        pod.kill_node(2)
        wait_for_history(
            hist_dir,
            lambda es: any(e["world"] == 2 and e["step"] > pre_kill
                           and e["gen"] > gen_rejoined for e in es),
            timeout=60)
        rcs = pod.wait(idxs=[0, 1], timeout=180)
        assert rcs == {0: 0, 1: 0}, \
            {i: pod.agent_log(i) for i in (0, 1)}
        entries = read_history(hist_dir)
        assert {e["step"] for e in entries} == set(range(total))
        assert _final_state(ckpt_dir, total - 1) == expected_state(total)
    finally:
        pod.shutdown()
        store.close()


@pytest.mark.slow
def test_wedged_node_is_evicted_and_rejoins_after_thaw(tmp_path):
    """SIGSTOP freezes a whole node; the survivors evict it, and after
    SIGCONT the thawed agent tears its stale trainers down and rejoins."""
    from _chaos_helpers import _descendants
    total, dt = 50, 0.25
    store, pod, ckpt_dir, hist_dir = _make_pod(
        tmp_path, LIGHT_TRAINER, total, dt)
    frozen = []
    try:
        pod.start_all()
        wait_for_checkpoint(ckpt_dir, 3, timeout=90)
        frozen = [pod.agents[2].pid] + _descendants(pod.agents[2].pid)
        for pid in frozen:
            os.kill(pid, signal.SIGSTOP)
        wait_for_history(
            hist_dir, lambda es: sum(e["world"] == 2 for e in es) >= 4,
            timeout=60)
        for pid in frozen:
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
        wait_for_history(
            hist_dir, lambda es: any(e["world"] == 3 and e["gen"] >= 2
                                     for e in es), timeout=90)
        rcs = pod.wait(timeout=180)
        assert all(rc == 0 for rc in rcs.values()), \
            {i: pod.agent_log(i) for i in rcs}
        assert {e["step"] for e in read_history(hist_dir)} == \
            set(range(total))
        assert _final_state(ckpt_dir, total - 1) == expected_state(total)
    finally:
        for pid in frozen:
            try:
                os.kill(pid, signal.SIGCONT)
            except (ProcessLookupError, PermissionError):
                pass
        pod.shutdown()
        store.close()


@pytest.mark.slow
def test_store_stall_does_not_trigger_spurious_scale_in(tmp_path):
    """SIGSTOP the store for less than the heartbeat timeout: nothing is
    declared dead and the fleet finishes at generation 0."""
    total, dt = 20, 0.2
    store, pod, ckpt_dir, hist_dir = _make_pod(
        tmp_path, LIGHT_TRAINER, total, dt, nnodes=2, min_nnodes=2)
    try:
        pod.start_all()
        wait_for_checkpoint(ckpt_dir, 2, timeout=90)
        store.stall(0.6)
        rcs = pod.wait(timeout=120)
        assert all(rc == 0 for rc in rcs.values()), \
            {i: pod.agent_log(i) for i in rcs}
        entries = read_history(hist_dir)
        assert {e["gen"] for e in entries} == {0}
        assert {e["world"] for e in entries} == {2}
        assert _final_state(ckpt_dir, total - 1) == expected_state(total)
    finally:
        pod.shutdown()
        store.close()


def test_local_failure_consumes_restart_budget(tmp_path):
    """A trainer that crashes (not a node that dies) is a local failure:
    the agent bumps the generation, restarts from the checkpoint and the
    budget is consumed."""
    crash_trainer = r"""
import json, os, sys
ckpt_dir = os.environ["PADDLE_ELASTIC_CKPT_DIR"]
restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
os.makedirs(ckpt_dir, exist_ok=True)
p = os.path.join(ckpt_dir, "step_0")
os.makedirs(p, exist_ok=True)
with open(os.path.join(p, "state.json"), "w") as f:
    json.dump({"step": 0, "state": 7}, f)
with open(os.path.join(p, ".done"), "w") as f:
    f.write("1")
if restart == 0:
    sys.exit(13)
print(f"recovered restart={restart}", flush=True)
"""
    script = tmp_path / "crash.py"
    script.write_text(crash_trainer)
    env = chaos_env(tmp_path / "ckpts")
    store = PortStoreServer(env=env)
    pod = PortPod(script, nnodes=1, min_nnodes=1, store_port=store.port,
                  env=env, log_root=tmp_path / "logs", max_restarts=2)
    try:
        pod.start_node(0)
        assert pod.wait(timeout=120) == {0: 0}, pod.agent_log(0)
        log = pod.agent_log(0)
        assert "restart 1/2" in log, log
        gen1 = os.path.join(str(tmp_path / "logs"), "node0", "gen1",
                            "workerlog.0")
        assert os.path.exists(gen1) and "recovered restart=1" in \
            open(gen1).read()
    finally:
        pod.shutdown()
        store.close()
