"""The replicated membership store on the port
(``paddle_tpu_torch/distributed/store_ha.py`` over
``native/store/tcp_store.cpp``), as ``tests/test_store_ha.py`` runs it on
the reference:

- the replication plane in one process (the port's ``TCPStore`` hosting
  a primary and standbys): synchronous mirroring, snapshot catch-up,
  standbys refusing data ops, a deposed primary fencing itself, an
  idempotent promotion;
- the port's ``ReplicatedStore`` client: endpoint parsing as the
  reference's, failover to the highest standby with ``on_failover`` once
  per epoch, the loss of every replica fatal, a key timeout no failover;
- the failover's choice held to the reference's: both clients, fed the
  same planted probe results through a fake substrate, promote the same
  standby with the same peers, attach to the same primary and fire the
  same callbacks;
- the real process topology (the port's ``--serve_store`` processes and
  launcher, ``tests/_torch_chaos_helpers.py``): the primary SIGKILLed mid
  training, the pod resuming on the promoted standby with the exact state
  (tier-1); a standby killed and the primary SIGSTOPped are marked slow,
  as in the reference."""
import os
import random
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _chaos_helpers import (LIGHT_TRAINER, chaos_env,  # noqa: E402
                            expected_state, wait_for_checkpoint)
from _torch_chaos_helpers import PortPod, PortReplicatedCluster  # noqa: E402

from paddle_tpu_torch.distributed.store import (  # noqa: E402
    ROLE_FENCED, ROLE_PRIMARY, ROLE_STANDBY, TCPStore, probe_endpoint,
    promote_endpoint)
from paddle_tpu_torch.distributed.store_ha import (  # noqa: E402
    ReplicatedStore, parse_endpoints)


# -- the replication plane in one process -------------------------------------

def _trio():
    prim = TCPStore(is_master=True, world_size=1)
    sbs = [TCPStore(is_master=True, world_size=1) for _ in range(2)]
    for sb in sbs:
        sb.server_set_standby()
        assert prim.server_add_replica("127.0.0.1", sb.port)
    return prim, sbs


def test_mirroring_is_synchronous_and_replayed():
    prim, (sb1, sb2) = _trio()
    try:
        prim.set("k", b"v")
        prim.delete_key("k")
        prim.set("k2", b"v2")
        e, s, role = prim.server_info()
        assert role == ROLE_PRIMARY
        for sb in (sb1, sb2):
            assert sb.server_info() == (e, s, ROLE_STANDBY)
        tail = prim.journal_tail(0)
        assert tail["epoch"] == e
        writes = [w for ent in tail["entries"] for w in ent["writes"]]
        assert {"key": b"k2", "val": b"v2"} in [
            {"key": w["key"], "val": w["val"]} for w in writes]
    finally:
        for s_ in (prim, sb1, sb2):
            s_.close()


def test_late_standby_catches_up_via_snapshot():
    prim = TCPStore(is_master=True, world_size=1)
    late = TCPStore(is_master=True, world_size=1)
    try:
        for i in range(20):
            prim.set(f"k{i}", str(i))
        late.server_set_standby()
        assert prim.server_add_replica("127.0.0.1", late.port)
        assert late.server_info()[:2] == prim.server_info()[:2]
        epoch = promote_endpoint("127.0.0.1", late.port)
        assert epoch == prim.server_info()[0] + 1
        c = TCPStore(host="127.0.0.1", port=late.port, world_size=1)
        assert c.get("k17") == b"17"
        c.close()
    finally:
        prim.close()
        late.close()


def test_standby_refuses_data_ops():
    sb = TCPStore(is_master=True, world_size=1)
    sb.server_set_standby()
    try:
        c = TCPStore(host="127.0.0.1", port=sb.port, world_size=1)
        with pytest.raises(RuntimeError):
            c.set("k", b"v")
        c.close()
    finally:
        sb.close()


def test_deposed_primary_fences_itself():
    prim, (sb1, sb2) = _trio()
    try:
        prim.set("before", b"1")
        assert promote_endpoint("127.0.0.1", sb1.port) == 2
        c = TCPStore(host="127.0.0.1", port=prim.port, world_size=1)
        with pytest.raises(RuntimeError):
            c.set("after", b"2")
        c.close()
        assert probe_endpoint("127.0.0.1", prim.port)[2] == ROLE_FENCED
        c1 = TCPStore(host="127.0.0.1", port=sb1.port, world_size=1)
        assert c1.check("before") and not c1.check("after")
        c1.close()
    finally:
        for s_ in (prim, sb1, sb2):
            s_.close()


def test_promotion_is_idempotent_and_deterministic():
    prim, (sb1, sb2) = _trio()
    try:
        prim.set("k", b"v")
        e1 = promote_endpoint("127.0.0.1", sb1.port,
                              peers=[f"127.0.0.1:{sb2.port}"])
        e2 = promote_endpoint("127.0.0.1", sb1.port,
                              peers=[f"127.0.0.1:{sb2.port}"])
        assert e1 == e2 == 2
        c = TCPStore(host="127.0.0.1", port=sb1.port, world_size=1)
        c.set("k2", b"v2")
        assert sb2.server_info()[0] == 2
        c.close()
    finally:
        for s_ in (prim, sb1, sb2):
            s_.close()


# -- the client ---------------------------------------------------------------

@pytest.mark.parametrize("spec", ["h1:1,h2:2", [("h", 3)], ["a:5", "b:6"],
                                  " h:7 ,", "h1", "", "h:x", ":5"])
def test_parse_endpoints(spec):
    from paddle_tpu.distributed.store_ha import parse_endpoints as jparse
    try:
        want = jparse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_endpoints(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_endpoints(spec) == want


def test_client_failover_promotes_highest_and_fires_once():
    prim, (sb1, sb2) = _trio()
    events = []
    rs = None
    try:
        prim.set("k", b"v")
        eps = [("127.0.0.1", p.port) for p in (prim, sb1, sb2)]
        rs = ReplicatedStore(eps, failover_timeout=20,
                             on_failover=events.append)
        assert rs.epoch == 1 and rs.get("k") == b"v"
        prim.close()
        assert rs.get("k") == b"v"
        assert rs.epoch == 2 and events == [2]
        rs.set("k2", b"v2")
        assert events == [2]
        others = [sb for sb in (sb1, sb2) if sb.port != rs.port]
        assert others[0].server_info()[0] == 2
        others[0].close()
        rs.set("k3", b"v3")
        assert rs.get("k3") == b"v3" and rs.epoch == 2
    finally:
        if rs is not None:
            rs.close()
        for s_ in (prim, sb1, sb2):
            s_.close()


def test_all_replicas_lost_is_fatal():
    prim, (sb1, sb2) = _trio()
    rs = ReplicatedStore([("127.0.0.1", p.port) for p in (prim, sb1, sb2)],
                         failover_timeout=2.0, probe_timeout=0.2)
    for s_ in (prim, sb1, sb2):
        s_.close()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no reachable primary|failover"):
        rs.get("k")
    assert time.monotonic() - t0 < 15
    rs.close()


def test_key_timeout_is_not_failover():
    prim, (sb1, sb2) = _trio()
    rs = None
    try:
        rs = ReplicatedStore([("127.0.0.1", p.port)
                              for p in (prim, sb1, sb2)])
        with pytest.raises(TimeoutError):
            rs.wait(["never"], timeout=0.3)
        assert rs.epoch == 1
    finally:
        if rs is not None:
            rs.close()
        for s_ in (prim, sb1, sb2):
            s_.close()


# -- the failover's choice against the reference's ----------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s

    def wait(self, event, timeout=None):
        self.t += timeout or 0.0
        return event.is_set()


class _Conn:
    def __init__(self, sub, host, port):
        self.sub, self.host, self.port, self.rank = sub, host, port, None

    def get(self, key):
        if (self.host, self.port) in self.sub.dead:
            raise RuntimeError("connection lost")
        return b"v"

    def close(self):
        pass


class _Planted:
    """A substrate whose probes answer from a planted table and whose
    promotions and connections are recorded."""

    def __init__(self, table):
        self.clock = _Clock()
        self.table = dict(table)
        self.dead = set()
        self.log = []

    def probe(self, host, port, timeout=1.0):
        return self.table.get((host, port))

    def promote(self, host, port, peers=(), timeout=10.0):
        self.log.append(("promote", port, tuple(peers)))
        epoch, seqno, _ = self.table[(host, port)]
        self.table[(host, port)] = (epoch + 1, seqno, ROLE_PRIMARY)
        return epoch + 1

    def connect(self, host, port, **kw):
        self.log.append(("connect", port))
        return _Conn(self, host, port)

    def rng(self, name=""):
        return random.Random(0)

    def lock(self):
        return threading.RLock()


def _scenario(seed):
    """A first sweep with one primary at epoch 1 (endpoint 0), then that
    primary lost and the others' answers drawn from ``seed``."""
    rng = random.Random(seed)
    n = rng.randint(2, 5)
    eps = [("h", 7000 + i) for i in range(n)]
    first = {eps[0]: (1, 10, ROLE_PRIMARY)}
    for ep in eps[1:]:
        first[ep] = (1, rng.randint(5, 10), ROLE_STANDBY)
    second = {}
    for ep in eps[1:]:
        kind = rng.choice(["standby", "standby", "gone", "fenced",
                           "primary"])
        if kind == "standby":
            second[ep] = (rng.randint(1, 2), rng.randint(0, 12),
                          ROLE_STANDBY)
        elif kind == "fenced":
            second[ep] = (1, rng.randint(0, 12), ROLE_FENCED)
        elif kind == "primary":
            second[ep] = (rng.randint(0, 3), rng.randint(0, 12),
                          ROLE_PRIMARY)
    if not any(v[2] in (ROLE_STANDBY, ROLE_PRIMARY) and
               (v[2] == ROLE_STANDBY or v[0] >= 1) for v in second.values()):
        second[eps[-1]] = (1, 3, ROLE_STANDBY)
    return eps, first, second


def _drive(cls, eps, first, second):
    sub = _Planted(first)
    fired = []
    rs = cls(eps, timeout=20, failover_timeout=30, probe_timeout=0.1,
             on_failover=fired.append, substrate=sub)
    sub.table = dict(second)
    sub.dead.add(eps[0])
    got = rs.get("k")
    return sub.log, fired, rs.epoch, (rs.host, rs.port), got


@pytest.mark.parametrize("seed", range(0, 400, 25))
def test_failover_choice_matches_reference(seed):
    from paddle_tpu.distributed.store_ha import ReplicatedStore as JRS
    for s in range(seed, seed + 25):
        eps, first, second = _scenario(s)
        assert _drive(ReplicatedStore, eps, first, second) == \
            _drive(JRS, eps, first, second), (s, first, second)


# -- the real process topology ------------------------------------------------

def _make_ha_pod(tmp_path, total, dt, nnodes=2, n_standbys=2):
    script = tmp_path / "trainer.py"
    script.write_text(LIGHT_TRAINER)
    ckpt_dir = tmp_path / "ckpts"
    hist_dir = tmp_path / "hist"
    env = chaos_env(ckpt_dir)
    cluster = PortReplicatedCluster(n_standbys=n_standbys, env=env)
    pod = PortPod(script, nnodes=nnodes, min_nnodes=nnodes,
                  store_port=cluster.endpoints, env=env,
                  log_root=tmp_path / "logs",
                  script_args=[total, dt, hist_dir])
    return cluster, pod, ckpt_dir, hist_dir


def _final_state(ckpt_dir, step):
    import json
    with open(os.path.join(str(ckpt_dir), f"step_{step}",
                           "state.json")) as f:
        return json.load(f)["state"]


def test_primary_kill_midrun_resumes_on_promoted_standby(tmp_path):
    """SIGKILL the store's primary mid-training: the agents' clients
    promote the best standby, force at most one re-rendezvous, and the
    run ends in the never-failed run's state."""
    total, dt = 16, 0.25
    cluster, pod, ckpt_dir, hist_dir = _make_ha_pod(tmp_path, total, dt)
    probe = None
    try:
        pod.start_all()
        wait_for_checkpoint(ckpt_dir, 3, timeout=120)
        cluster.kill_primary()
        rcs = pod.wait(timeout=240)
        assert all(rc == 0 for rc in rcs.values()), \
            (rcs, pod.agent_log(0), pod.agent_log(1))
        assert _final_state(ckpt_dir, total - 1) == expected_state(total)
        probe = ReplicatedStore(cluster.endpoints, timeout=20,
                                probe_timeout=0.5)
        assert probe.epoch >= 2
        assert int(probe.get("__el/gen")) >= 1
        assert int(probe.get("__el/ha/bumps")) == 1
        logs = pod.agent_log(0) + pod.agent_log(1)
        assert "failed over" in logs
    finally:
        if probe is not None:
            probe.close()
        pod.shutdown()
        cluster.close()


@pytest.mark.slow
def test_standby_kill_is_a_noop(tmp_path):
    total, dt = 12, 0.25
    cluster, pod, ckpt_dir, hist_dir = _make_ha_pod(tmp_path, total, dt)
    probe = None
    try:
        pod.start_all()
        wait_for_checkpoint(ckpt_dir, 2, timeout=120)
        probe = ReplicatedStore(cluster.endpoints, timeout=20,
                                probe_timeout=0.5)
        gen_before = int(probe.get("__el/gen"))
        cluster.kill_standby(0)
        rcs = pod.wait(timeout=240)
        assert all(rc == 0 for rc in rcs.values()), rcs
        assert _final_state(ckpt_dir, total - 1) == expected_state(total)
        assert probe.epoch == 1
        assert int(probe.get("__el/gen")) == gen_before
        assert not probe.check("__el/ha/bumps")
    finally:
        if probe is not None:
            probe.close()
        pod.shutdown()
        cluster.close()


@pytest.mark.slow
def test_sigstop_primary_detected_and_failed_over(tmp_path):
    total, dt = 24, 0.4
    cluster, pod, ckpt_dir, hist_dir = _make_ha_pod(tmp_path, total, dt)
    probe = None
    try:
        pod.start_all()
        wait_for_checkpoint(ckpt_dir, 2, timeout=120)
        cluster.stall_primary()
        rcs = pod.wait(timeout=300)
        assert all(rc == 0 for rc in rcs.values()), \
            (rcs, pod.agent_log(0), pod.agent_log(1))
        assert _final_state(ckpt_dir, total - 1) == expected_state(total)
        probe = ReplicatedStore(cluster.endpoints, timeout=20,
                                probe_timeout=0.5)
        assert probe.epoch >= 2
        cluster.resume_primary()
        deadline = time.monotonic() + 30
        role = None
        while time.monotonic() < deadline:
            info = probe_endpoint("127.0.0.1", cluster.primary_port,
                                  timeout=1.0)
            role = info and info[2]
            if role == ROLE_FENCED:
                break
            try:
                c = TCPStore(host="127.0.0.1", port=cluster.primary_port,
                             world_size=1, timeout=2, op_timeout=2)
                try:
                    c.set("poke", b"1")
                finally:
                    c.close()
            except (RuntimeError, TimeoutError):
                pass
            time.sleep(0.25)
        assert role == ROLE_FENCED, f"deposed primary role={role}"
    finally:
        if probe is not None:
            probe.close()
        pod.shutdown()
        cluster.close()
