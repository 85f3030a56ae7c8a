"""The per-node elastic agent: ``run_pod`` inside store-backed membership
(counterpart: ``paddle_tpu/distributed/elastic/agent.py``; upstream's
elastic launch controller).

One agent runs on each node. It heartbeats a node id into the
``TCPStore``, rendezvouses through ``ElasticRendezvous`` for this
generation's (rank, nnodes), and starts the node's trainer ranks with the
new world through the launcher's env contract (``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ID``, ``PADDLE_MASTER``), plus ``PADDLE_ELASTIC_GENERATION``
and ``PADDLE_RESTART_COUNT``. When membership changes (a peer's heartbeat
goes stale, or a new node bumps the generation to join) it tears the local
ranks down (SIGTERM, then SIGKILL past the grace period), rendezvouses
again and restarts the trainers, which resume from ``latest_checkpoint()``.
Scale events do not consume the restart budget; only a local trainer's
failure does.

Tuning, from the environment (the reference's knobs):
``PADDLE_ELASTIC_HB_INTERVAL`` and ``PADDLE_ELASTIC_HB_TIMEOUT`` (failure
detection), ``PADDLE_ELASTIC_RDZV_TIMEOUT`` and ``PADDLE_ELASTIC_LAST_CALL``
(rendezvous), ``PADDLE_ELASTIC_GRACE`` (SIGTERM to SIGKILL).

SIGUSR1 pauses the agent's heartbeats and nothing else: to its peers the
node is then a zombie (a wedged host), which fault-injection tests use to
show that detection needs no clean death.

``python -m paddle_tpu_torch.distributed.elastic.agent --serve_store
[--port P] [--standby] [--replicas H:P,...]`` hosts the membership store
on its own.
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time

from . import (CKPT_DIR_ENV, GENERATION_ENV, RESTART_ENV, FailureDetector,
               latest_checkpoint)
from ...observability import flight as _obs_flight
from ...observability import metrics as _obs_metrics
from ...observability import trace as _obs_trace
from ..store import StoreOpTimeout
from ..substrate import NATIVE_SUBSTRATE
from .rendezvous import ElasticRendezvous


def _env_f(name, default):
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


class ElasticAgent:
    """A node's supervisor inside the membership. ``run()`` returns the
    job's exit code: 0 when the local trainers complete, non-zero when the
    restart budget is spent (the trainer's code), the rendezvous times out
    (3) or the membership store is lost (4)."""

    def __init__(self, cmd, nproc_per_node=1, store_host="127.0.0.1",
                 store_port=0, nnodes=1, min_nnodes=None, max_restarts=3,
                 log_dir=None, host_store=False, base_env=None,
                 ckpt_dir=None, hb_interval=None, hb_timeout=None,
                 rdzv_timeout=None, last_call=None, grace=None,
                 pod_master_factory=None, store_endpoints=None,
                 substrate=None):
        self._substrate = substrate if substrate is not None \
            else NATIVE_SUBSTRATE
        self._clock = self._substrate.clock
        self.cmd = list(cmd)
        self.nproc = int(nproc_per_node)
        # more than one endpoint makes the agent a ReplicatedStore client
        # that follows a primary's failover instead of exiting with 4
        if store_endpoints:
            from ..store_ha import parse_endpoints
            self.store_endpoints = parse_endpoints(store_endpoints)
            store_host, store_port = self.store_endpoints[0]
        else:
            self.store_endpoints = None
        self.store_host = store_host
        self.store_port = int(store_port)
        self.nnodes = int(nnodes)
        self.min_nnodes = int(min_nnodes or nnodes)
        self.max_restarts = int(max_restarts)
        self.log_dir = log_dir
        self.host_store = host_store
        self.base_env = base_env
        self.ckpt_dir = ckpt_dir
        self.hb_interval = hb_interval if hb_interval is not None \
            else _env_f("PADDLE_ELASTIC_HB_INTERVAL", 1.0)
        self.hb_timeout = hb_timeout if hb_timeout is not None \
            else _env_f("PADDLE_ELASTIC_HB_TIMEOUT", 5.0)
        self.rdzv_timeout = rdzv_timeout if rdzv_timeout is not None \
            else _env_f("PADDLE_ELASTIC_RDZV_TIMEOUT", 120.0)
        self.last_call = last_call if last_call is not None \
            else _env_f("PADDLE_ELASTIC_LAST_CALL", 1.0)
        self.grace = grace if grace is not None \
            else _env_f("PADDLE_ELASTIC_GRACE", 10.0)
        self.pod_master_factory = pod_master_factory
        self.restarts = 0
        self.node_id = None
        self._store = None
        self._detector = None
        self._stop_pod = threading.Event()
        self._current_gen = None

    # -- membership events ----------------------------------------------------
    def _on_peer_failure(self, dead):
        """The detector's thread: a peer's heartbeat went stale. Bump the
        generation (one of the racing survivors wins) and take the dead ids
        out of the liveness table, so a corpse is not reported to every
        later detector."""
        dead = [d for d in dead if d != self.node_id]
        if not dead:
            return  # this node's own heartbeats are paused: peers act
        _obs_trace.event("elastic.peer_death", node=self.node_id,
                         dead=list(dead))
        gen = self._current_gen
        if gen is None:
            # a death seen between pods (mid-rendezvous): bump the live
            # generation, since the dead node may hold slot 0 of the
            # pending round, which would otherwise wait for its timeout
            try:
                gen = self._rdzv.current_generation()
            except (RuntimeError, StoreOpTimeout):
                return  # the store is gone; the main loop owns that exit
        try:
            _, won = self._rdzv.bump_generation(gen)
            if won:
                for d in dead:
                    try:
                        self._store.deregister(rank=d)
                    except Exception:
                        pass  # the next sweep reaps it
        finally:
            # the local pod comes down even if the bump's round trip failed
            self._stop_pod.set()

    def _on_store_failover(self, epoch):
        """Our connection followed a failover to the primary of ``epoch``.
        Acknowledged state survived, but ops in flight at the old
        primary's death may be lost: force one re-rendezvous for the whole
        fleet (``add_unique`` on the epoch's key lets one agent, and one
        clone of its store, do it)."""
        store = self._store
        rdzv = getattr(self, "_rdzv", None)
        if store is None or rdzv is None:
            return  # a failover during start-up: nothing to settle yet
        _obs_trace.event("elastic.store_failover", node=self.node_id,
                         epoch=epoch)
        try:
            _, newly = store.add_unique(f"__el/ha/e{epoch}",
                                        "__el/ha/bumps")
            if newly:
                gen = rdzv.current_generation()
                rdzv.bump_generation(gen)
                print(f"elastic agent node{self.node_id}: store failed "
                      f"over (epoch {epoch}); forcing one re-rendezvous",
                      file=sys.stderr, flush=True)
        except Exception:
            pass  # the watcher and the rendezvous see the new primary anyway

    def _node_addr(self):
        """This node's address as its peers reach it (the trainer
        coordinator when this node closes a round): ``PADDLE_NODE_ADDR``,
        else the local end of the route to the store; a loopback store
        means every node is on one host."""
        addr = os.environ.get("PADDLE_NODE_ADDR")
        if addr:
            return addr
        if self.store_host in ("", "localhost", "127.0.0.1"):
            return "127.0.0.1"
        import socket
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.connect((self.store_host, self.store_port or 1))
                return s.getsockname()[0]
            finally:
                s.close()
        except OSError:
            return "127.0.0.1"

    def _default_pod_master_factory(self):
        from ..env import find_free_port
        return f"{self._node_addr()}:{find_free_port()}"

    def _watch_generation(self, gen, pod_done):
        """While the pod runs, a bump by any agent (a death's winner, a
        joining node, a local failure's retry) stops it."""
        while not self._clock.wait(pod_done, self.hb_interval):
            try:
                if self._rdzv.current_generation() != gen:
                    self._stop_pod.set()
                    return
            except (RuntimeError, StoreOpTimeout):
                return  # the store is gone: the pod's loop owns the exit

    def _attach_control_plane(self, store):
        """Join the membership: take this agent life's node id, record its
        liveness, and build the rendezvous and the detector over
        ``store``."""
        self._store = store
        # unique per agent life: a host that comes back gets a new id, so
        # its old entry is never taken for the live process
        self.node_id = store.add("__el/nid", 1) - 1
        store.rank = self.node_id
        # heartbeat before registering in any round: dead_ranks reports
        # only ranks that beat once, so an agent killed between joining a
        # round and its first beat would hold the round open unseen
        store.heartbeat()
        node_name = f"node{self.node_id}"
        self._rdzv = ElasticRendezvous(
            store, node_name, self.min_nnodes, self.nnodes,
            timeout=self.rdzv_timeout, last_call=self.last_call,
            pod_master_factory=(self.pod_master_factory
                                or self._default_pod_master_factory),
            clock=self._clock)
        self._detector = FailureDetector(
            store, interval=self.hb_interval, timeout=self.hb_timeout,
            on_failure=self._on_peer_failure, clock=self._clock)
        return node_name

    # -- the main loop --------------------------------------------------------
    def run(self):
        from ..launch.main import run_pod
        from ..store import TCPStore
        try:
            if self.store_endpoints and len(self.store_endpoints) > 1:
                from ..store_ha import ReplicatedStore
                store = ReplicatedStore(
                    self.store_endpoints, world_size=1,
                    timeout=max(30.0, self.rdzv_timeout),
                    on_failover=self._on_store_failover,
                    substrate=self._substrate)
            else:
                store = TCPStore(host=self.store_host,
                                 port=self.store_port,
                                 is_master=self.host_store, world_size=1,
                                 timeout=max(30.0, self.rdzv_timeout))
        except (TimeoutError, RuntimeError) as e:
            # nobody hosts the store, or hosting it failed (port taken)
            print(f"elastic agent: cannot {'host' if self.host_store else 'reach'} "
                  f"the membership store at "
                  f"{self.store_endpoints or [(self.store_host, self.store_port)]} "
                  f"({e})", file=sys.stderr)
            return 4
        self._attach_control_plane(store)
        prev_usr1 = None
        try:
            prev_usr1 = signal.signal(
                signal.SIGUSR1,
                lambda *_: self._detector.pause_heartbeats())
        except ValueError:
            pass  # not the main thread (embedded use): no zombie hook
        self._detector.start()
        try:
            return self._run_loop(run_pod)
        except (RuntimeError, StoreOpTimeout) as e:
            # the membership store is gone: a plain TCPStore's lost
            # connection, or a ReplicatedStore that lost every replica
            print(f"elastic agent: membership store lost: {e}",
                  file=sys.stderr)
            return 4
        finally:
            if prev_usr1 is not None:
                try:
                    signal.signal(signal.SIGUSR1, prev_usr1)
                except ValueError:
                    pass
            # publish this agent's metrics through the shared store, so a
            # survivor or an operator can read one fleet-wide snapshot
            if _obs_trace.enabled() or _obs_flight.enabled():
                try:
                    _obs_metrics.publish(store, f"agent{self.node_id}")
                except Exception:
                    pass  # best effort: the store may be what just died
            self._detector.stop(deregister=True)
            store.close()

    def _run_loop(self, run_pod):
        while True:
            try:
                with _obs_trace.span("elastic.rendezvous",
                                     node=self.node_id) as rdzv_sp:
                    info = self._rdzv.next_rendezvous()
                    rdzv_sp.set_attrs(generation=info.generation,
                                      rank=info.rank, nnodes=info.nnodes)
            except TimeoutError as e:
                print(f"elastic agent: {e}", file=sys.stderr)
                return 3
            # a node that completes a rendezvous is monitored again, or a
            # zombie that rejoined would stay silent for good
            self._detector.resume_heartbeats()
            gen = info.generation
            world = info.nnodes * self.nproc
            ranks = range(info.rank * self.nproc,
                          (info.rank + 1) * self.nproc)
            extra_env = {GENERATION_ENV: str(gen),
                         RESTART_ENV: str(self.restarts)}
            if self.ckpt_dir:
                extra_env[CKPT_DIR_ENV] = self.ckpt_dir
            ckpt = latest_checkpoint(self.ckpt_dir)
            print(f"elastic agent node{self.node_id}: generation {gen} "
                  f"rank {info.rank}/{info.nnodes} world {world} "
                  f"resume={ckpt or 'scratch'}", file=sys.stderr, flush=True)
            log_dir = None if self.log_dir is None else os.path.join(
                self.log_dir, f"gen{gen}")
            self._stop_pod.clear()
            self._current_gen = gen
            pod_done = threading.Event()
            watcher = self._substrate.spawn(
                f"gen-watcher-{gen}",
                lambda: self._watch_generation(gen, pod_done))
            with _obs_trace.span("elastic.pod", node=self.node_id,
                                 generation=gen, world=world,
                                 resumed_from=ckpt or "scratch") as pod_sp:
                rc = run_pod(self.cmd, ranks, world, info.pod_master,
                             log_dir=log_dir, base_env=self.base_env,
                             stop=self._stop_pod, grace=self.grace,
                             extra_env=extra_env)
                pod_sp.set_attrs(rc=rc)
            pod_done.set()
            watcher.join(timeout=5)
            self._current_gen = None
            if self._stop_pod.is_set() or \
                    self._rdzv.current_generation() != gen:
                # membership changed: rendezvous again and resume from the
                # checkpoint without consuming the restart budget
                continue
            if rc == 0:
                return 0
            # a non-zero rc can be the collateral of a peer's death that
            # detection has not seen yet (collectives fail within ms of a
            # peer vanishing, the heartbeat verdict takes hb_timeout): give
            # detection one window to reclassify it first. A one-node world
            # has no peer to wait for.
            if info.nnodes > 1:
                grace = self._clock.monotonic() + \
                    self.hb_timeout + 2 * self.hb_interval
                while self._clock.monotonic() < grace:
                    if self._stop_pod.is_set() or \
                            self._rdzv.current_generation() != gen:
                        break
                    self._clock.sleep(min(0.05, self.hb_interval))
            if self._stop_pod.is_set() or \
                    self._rdzv.current_generation() != gen:
                continue
            self.restarts += 1
            # a local trainer failed: the collective job is broken
            # everywhere, so the whole fleet moves to a new generation
            self._rdzv.bump_generation(gen)
            if self.restarts > self.max_restarts:
                print(f"elastic agent: giving up after {self.restarts - 1} "
                      f"restarts (rc={rc})", file=sys.stderr)
                return rc
            print(f"elastic agent: local pod failed (rc={rc}); restart "
                  f"{self.restarts}/{self.max_restarts} at a new "
                  f"generation", file=sys.stderr, flush=True)


def _install_stop_handlers(stop, signals=(signal.SIGTERM, signal.SIGINT)):
    """``stop.set()`` as the handler of ``signals``; returns ``restore()``,
    which puts the previous handlers back."""
    prev = {s: signal.signal(s, lambda *_: stop.set()) for s in signals}

    def restore():
        for s, prev_h in prev.items():
            signal.signal(s, prev_h)

    return restore


def serve_store(port, replicas=None, standby=False, attach_timeout=30.0):
    """Host a ``TCPStore`` server, the membership the agents of one job
    share, until SIGTERM or SIGINT. ``standby=True`` serves a standby (it
    refuses data ops and waits for a primary to sync it). ``replicas``
    (``"host:port,..."`` or a list) makes this the primary of a replicated
    store: each standby is attached (synced by snapshot or journal replay,
    then mirrored before every acknowledgement), retried until
    ``attach_timeout``. Start the standbys first, then the primary::

        agent --serve_store --standby --port P1   (x N)
        agent --serve_store --port P0 --replicas h:P1,h:P2

    A standby that dies is dropped from the mirroring; a dead primary is
    replaced on the client side (``ReplicatedStore`` promotes the standby
    of the highest (epoch, seqno))."""
    from ..store import TCPStore
    store = TCPStore(port=port, is_master=True, world_size=1)
    if standby:
        store.server_set_standby()
    print(f"STORE_PORT={store.port}", flush=True)
    if replicas:
        from ..store_ha import parse_endpoints
        attached = 0
        for host, rport in parse_endpoints(replicas):
            deadline = time.monotonic() + attach_timeout
            while True:
                if store.server_add_replica(host, rport):
                    attached += 1
                    break
                if time.monotonic() >= deadline:
                    print(f"serve_store: standby {host}:{rport} "
                          f"unreachable within {attach_timeout}s; "
                          "serving without it", file=sys.stderr,
                          flush=True)
                    break
                time.sleep(0.2)
        print(f"STORE_REPLICAS={attached}", flush=True)
    stop = threading.Event()
    restore_handlers = _install_stop_handlers(stop)
    while not stop.is_set():
        time.sleep(0.1)
    restore_handlers()
    store.close()
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--serve_store" in argv:
        port = 0
        if "--port" in argv:
            port = int(argv[argv.index("--port") + 1])
        replicas = None
        if "--replicas" in argv:
            replicas = argv[argv.index("--replicas") + 1]
        sys.exit(serve_store(port, replicas=replicas,
                             standby="--standby" in argv))
    print("usage: python -m paddle_tpu_torch.distributed.elastic.agent "
          "--serve_store [--port P] [--standby] "
          "[--replicas H:P,H:P,...]   (agents start via "
          "`python -m paddle_tpu_torch.distributed.launch --elastic "
          "--nnodes N --min_nnodes M --master H:P[,H:P...] ...`)",
          file=sys.stderr)
    sys.exit(2)


if __name__ == "__main__":
    main()
