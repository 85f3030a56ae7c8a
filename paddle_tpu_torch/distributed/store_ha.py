"""``ReplicatedStore``: a ``TCPStore`` client that survives the loss of the
store's primary (counterpart: ``paddle_tpu/distributed/store_ha.py``).

The server side is ``native/store/tcp_store.cpp``, which both packages
build: ``python -m paddle_tpu_torch.distributed.elastic.agent --serve_store
--replicas h:p,...`` runs one primary that mirrors every mutating op to its
standbys before it acknowledges the client. This module is the client:

- every op retries a passing failure with a capped, doubling backoff;
- a lost connection, or an op whose deadline expired (``StoreOpTimeout``,
  a stopped primary), starts a failover: probe every endpoint, follow a
  primary at an epoch no older than ours if there is one, else promote the
  best standby, the highest (epoch, seqno), ties to the earlier endpoint,
  fenced nodes left out. Racing clients pick the same node, and a second
  promotion of it changes nothing;
- each rise of the epoch calls ``on_failover(epoch)`` once per client;
  ``ElasticAgent`` turns that into one generation bump for the whole fleet,
  so the rendezvous settles whatever the old primary took with it.
  Acknowledged state is never lost: the mirroring is synchronous.

A plain ``TimeoutError`` from ``wait`` (the key did not appear on a healthy
server) never starts a failover; only ``StoreOpTimeout`` and
``RuntimeError`` (connection lost) do. ``KeyError`` from ``get`` passes
through. Losing the primary and every standby at once is fatal: ops raise
``RuntimeError`` once ``PADDLE_STORE_FAILOVER_TIMEOUT`` has run out, which
the elastic agent turns into its exit code 4. Network partitions are out of
scope: clients that reach disjoint sets of nodes could promote different
standbys.
"""
from __future__ import annotations

import os
import sys

from ..observability import metrics as _obs_metrics
from ..observability import trace as _obs_trace
from .store import ROLE_PRIMARY, ROLE_STANDBY, StoreOpTimeout, TCPStore
from .substrate import NATIVE_SUBSTRATE

STORE_RETRIES = _obs_metrics.counter(
    "store_client_retries_total",
    help="ReplicatedStore op retries after a transient failure or "
         "primary loss, per op")
STORE_FAILOVERS = _obs_metrics.counter(
    "store_failovers_total",
    help="epoch increases this client followed/performed")

FAILOVER_TIMEOUT_ENV = "PADDLE_STORE_FAILOVER_TIMEOUT"
PROBE_TIMEOUT_ENV = "PADDLE_STORE_PROBE_TIMEOUT"


def _env_f(name, default):
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def parse_endpoints(spec):
    """``"host:port[,host:port...]"`` (or an iterable of such strings or of
    (host, port) pairs) -> ``[(host, port), ...]``. Raises ``ValueError``
    on a malformed part; the launcher reports that as an argument error."""
    if isinstance(spec, str):
        parts = [p for p in spec.split(",") if p.strip()]
    else:
        parts = list(spec)
    out = []
    for p in parts:
        if isinstance(p, (tuple, list)):
            host, port = p
        else:
            host, _, port = p.strip().rpartition(":")
            if not host or not str(port).isdigit():
                raise ValueError(f"malformed store endpoint {p!r} "
                                 "(expected host:port)")
        out.append((host, int(port)))
    if not out:
        raise ValueError("empty store endpoint list")
    return out


def choose_target(probes, epoch):
    """The failover's choice among ``probes`` (``(index, host, port,
    epoch, seqno, role)`` of each endpoint that answered), as ``("attach",
    probe)`` for a primary at an epoch no older than ``epoch`` (the highest
    epoch, ties to the earlier endpoint), else ``("promote", probe)`` for
    the standby of the highest (epoch, seqno), ties to the earlier
    endpoint, else None."""
    primaries = [p for p in probes if p[5] == ROLE_PRIMARY and p[3] >= epoch]
    if primaries:
        return "attach", max(primaries, key=lambda p: (p[3], -p[0]))
    standbys = [p for p in probes if p[5] == ROLE_STANDBY]
    if standbys:
        return "promote", max(standbys, key=lambda p: (p[3], p[4], -p[0]))
    return None


class ReplicatedStore:
    """A ``TCPStore``-compatible client over a list of endpoints: the same
    key-value, liveness and barrier surface, with retry and failover."""

    def __init__(self, endpoints, world_size=1, rank=None, timeout=30.0,
                 op_timeout=None, probe_timeout=None, failover_timeout=None,
                 on_failover=None, substrate=None):
        self._substrate = substrate if substrate is not None \
            else NATIVE_SUBSTRATE
        self._clock = self._substrate.clock
        self.endpoints = parse_endpoints(endpoints)
        self.world_size = world_size
        self._rank = rank
        self.timeout = float(timeout)
        self.op_timeout = op_timeout
        self.probe_timeout = (probe_timeout if probe_timeout is not None
                              else _env_f(PROBE_TIMEOUT_ENV, 1.0))
        self.failover_timeout = (
            failover_timeout if failover_timeout is not None
            else _env_f(FAILOVER_TIMEOUT_ENV, 60.0))
        self.on_failover = on_failover
        self._lock = self._substrate.lock()  # guards the swaps of _store
        # jitter on the failover backoff, so the clients of a fleet do not
        # probe every endpoint in lockstep
        self._rng = self._substrate.rng(f"store-backoff:{rank}")
        self._store = None
        # deposed connections: closing a TCPStore frees its C handle under
        # any thread still blocked in it, so they are freed in close()
        self._retired = []
        self.epoch = 0
        self._notified_epoch = None  # the first attach's epoch calls nothing
        deadline = self._clock.monotonic() + self.timeout
        with self._lock:
            self._locate_and_attach(deadline, initial=True)

    # -- the connection -------------------------------------------------------
    @property
    def rank(self):
        return self._rank

    @rank.setter
    def rank(self, value):
        self._rank = value
        st = self._store
        if st is not None:
            st.rank = value

    @property
    def host(self):
        return self._store.host

    @property
    def port(self):
        return self._store.port

    def _probe_all(self):
        """``[(index, host, port, epoch, seqno, role), ...]`` of the
        endpoints that answered."""
        out = []
        for i, (h, p) in enumerate(self.endpoints):
            info = self._substrate.probe(h, p, timeout=self.probe_timeout)
            if info is not None:
                out.append((i, h, p) + info)
        return out

    def _attach(self, idx, host, port, epoch):
        # connect first, swap after: _store stays valid for the other
        # threads throughout, and a failed attach leaves the old one
        new = self._substrate.connect(
            host, port, world_size=self.world_size, rank=self._rank,
            timeout=min(self.timeout, 10.0), op_timeout=self.op_timeout)
        old, self._store = self._store, new
        if old is not None:
            self._retired.append(old)
        self.epoch = epoch
        if self._notified_epoch is None:
            self._notified_epoch = epoch
        elif epoch > self._notified_epoch:
            self._notified_epoch = epoch
            STORE_FAILOVERS.inc()
            _obs_trace.event("store.failover", epoch=epoch,
                             endpoint=f"{host}:{port}")
            print(f"ReplicatedStore: failed over to {host}:{port} "
                  f"(epoch {epoch})", file=sys.stderr, flush=True)
            if self.on_failover is not None:
                self.on_failover(epoch)

    def _locate_and_attach(self, deadline, initial=False):
        with _obs_trace.span("store.relocate", initial=initial) as sp:
            self._locate_and_attach_impl(deadline, initial=initial)
            sp.set_attrs(epoch=self.epoch,
                         endpoint=f"{self.host}:{self.port}")

    def _locate_and_attach_impl(self, deadline, initial=False):
        """Find the primary (or make one by promotion) and connect to it.
        At start the primary may still be attaching its standbys, so the
        first hunt promotes only after some fruitless probing; a failover
        at run time promotes on the first sweep without a primary."""
        promote_after = (self._clock.monotonic() + min(5.0, self.timeout / 2)
                         if initial else 0.0)
        backoff = 0.05
        last_seen = None
        while True:
            probes = self._probe_all()
            choice = choose_target(probes, self.epoch)
            if choice is not None and choice[0] == "attach":
                best = choice[1]
                try:
                    self._attach(best[0], best[1], best[2], best[3])
                    return
                except (RuntimeError, TimeoutError) as e:
                    last_seen = e
            elif choice is not None and \
                    self._clock.monotonic() >= promote_after:
                target = choice[1]
                peers = [f"{h}:{pt}" for i, h, pt, _, _, role in probes
                         if role == ROLE_STANDBY and i != target[0]]
                epoch = self._substrate.promote(
                    target[1], target[2], peers=peers, timeout=10.0)
                if epoch is not None:
                    try:
                        self._attach(target[0], target[1], target[2],
                                     epoch)
                        return
                    except (RuntimeError, TimeoutError) as e:
                        last_seen = e
            if self._clock.monotonic() >= deadline:
                raise RuntimeError(
                    f"ReplicatedStore: no reachable primary among "
                    f"{self.endpoints} (last error: {last_seen})")
            # jitter only stretches the sleep, never shortens it
            self._clock.sleep(backoff * (1.0 + self._rng.random()))
            backoff = min(backoff * 2, 1.0)

    # -- retrying delegation --------------------------------------------------
    def _op(self, opname, *args, **kwargs):
        deadline = self._clock.monotonic() + self.failover_timeout
        backoff = 0.05
        while True:
            st = self._store
            if st is None:
                raise RuntimeError(
                    f"ReplicatedStore.{opname}: store is closed")
            try:
                return getattr(st, opname)(*args, **kwargs)
            except StoreOpTimeout as e:
                last = e
                STORE_RETRIES.inc(op=opname, error="op_timeout")
            except RuntimeError as e:
                last = e
                STORE_RETRIES.inc(op=opname, error="connection")
            # at least once: an op whose acknowledgement was lost may have
            # committed; every use in the elastic stack tolerates a retry
            if self._clock.monotonic() >= deadline:
                raise RuntimeError(
                    f"ReplicatedStore.{opname}: store lost and failover "
                    f"did not complete within {self.failover_timeout}s "
                    f"({last})")
            with self._lock:
                if self._store is st:  # the first thread in relocates;
                    # the later ones retry on the swapped store
                    try:
                        self._locate_and_attach(deadline)
                    except RuntimeError as e:
                        raise RuntimeError(
                            f"ReplicatedStore.{opname}: {e}") from last
            self._clock.sleep(backoff * (1.0 + self._rng.random()))
            backoff = min(backoff * 2, 1.0)

    def set(self, key, value):
        return self._op("set", key, value)

    def get(self, key):
        return self._op("get", key)

    def add(self, key, amount=1):
        return self._op("add", key, amount)

    def add_unique(self, member_key, counter_key):
        return self._op("add_unique", member_key, counter_key)

    def compare_set(self, key, expected, desired):
        return self._op("compare_set", key, expected, desired)

    def wait(self, keys, timeout=None):
        return self._op("wait", keys, timeout=timeout)

    def check(self, key):
        return self._op("check", key)

    def delete_key(self, key):
        return self._op("delete_key", key)

    def num_keys(self):
        return self._op("num_keys")

    def heartbeat(self, rank=None):
        return self._op("heartbeat", rank)

    def dead_ranks(self, timeout=10.0, max_ranks=4096):
        return self._op("dead_ranks", timeout, max_ranks)

    def deregister(self, rank=None):
        return self._op("deregister", rank)

    def ha_info(self):
        return self._op("ha_info")

    # the barrier's state lives on the server and each of its ops retries,
    # so the stock protocol survives a failover as it is
    barrier = TCPStore.barrier

    def clone(self):
        """A connection of its own with the same endpoints, identity and
        failover (a detector thread's channel)."""
        return ReplicatedStore(
            list(self.endpoints), world_size=self.world_size,
            rank=self._rank, timeout=self.timeout,
            op_timeout=self.op_timeout, probe_timeout=self.probe_timeout,
            failover_timeout=self.failover_timeout,
            on_failover=self.on_failover, substrate=self._substrate)

    def close(self):
        st, self._store = self._store, None
        retired, self._retired = self._retired, []
        for r in retired + ([st] if st is not None else []):
            r.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
