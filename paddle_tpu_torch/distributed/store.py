"""TCPStore: rendezvous key-value store (C++ core, ctypes binding; a copy
of ``paddle_tpu/distributed/store.py`` over the same
``native/store/tcp_store.cpp``, so both packages speak one wire protocol).

Reference surface: `paddle/fluid/distributed/store/tcp_store` +
`paddle.distributed.TCPStore`-style usage [U] (SURVEY.md §2.1 Store row,
§3.4 step B: workers rendezvous through rank-0's store to exchange
communicator bootstrap info). The C++ server/client live in
native/store/tcp_store.cpp; this module loads them via ctypes and keeps the
reference's API: set/get/add/wait/barrier semantics with is_master hosting.
"""
from __future__ import annotations

import ctypes
import functools
import os
import time

from ..observability import metrics as _obs_metrics
from ..utils.native_build import build_shared

_lib = None

# server roles reported by probe_endpoint / TCPStore.ha_info
ROLE_PRIMARY = 0
ROLE_STANDBY = 1
ROLE_FENCED = 2

OP_TIMEOUT_ENV = "PADDLE_STORE_OP_TIMEOUT"
_DEFAULT_OP_TIMEOUT = 300.0  # seconds; 0 disables (legacy unbounded ops)


class StoreOpTimeout(TimeoutError):
    """An op's RECV DEADLINE expired: the server is hung/stalled (vs a
    plain TimeoutError from wait(), which means the KEY did not appear
    within the requested server-side timeout on a healthy server). The
    failover client treats this — like a lost connection — as primary
    loss; a key timeout is never grounds for failover."""


def default_op_timeout():
    """Env-tunable op deadline (seconds; 0 disables): bounds every store
    round-trip so a hung store surfaces as StoreOpTimeout in agent poll
    loops instead of an unbounded hang."""
    try:
        return float(os.environ.get(OP_TIMEOUT_ENV, _DEFAULT_OP_TIMEOUT))
    except ValueError:
        return _DEFAULT_OP_TIMEOUT


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build_shared("pd_store", ["native/store/tcp_store.cpp"])
    lib = ctypes.CDLL(path)
    lib.pd_tcpstore_server_start.restype = ctypes.c_void_p
    lib.pd_tcpstore_server_start.argtypes = [ctypes.c_int]
    lib.pd_tcpstore_server_port.restype = ctypes.c_int
    lib.pd_tcpstore_server_port.argtypes = [ctypes.c_void_p]
    lib.pd_tcpstore_server_stop.argtypes = [ctypes.c_void_p]
    lib.pd_tcpstore_connect.restype = ctypes.c_void_p
    lib.pd_tcpstore_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int]
    lib.pd_tcpstore_close.argtypes = [ctypes.c_void_p]
    lib.pd_tcpstore_set.restype = ctypes.c_int
    lib.pd_tcpstore_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.pd_tcpstore_get.restype = ctypes.c_longlong
    lib.pd_tcpstore_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_longlong]
    lib.pd_tcpstore_add.restype = ctypes.c_longlong
    lib.pd_tcpstore_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_longlong]
    lib.pd_tcpstore_add2.restype = ctypes.c_int
    lib.pd_tcpstore_add2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int, ctypes.c_longlong,
                                     ctypes.POINTER(ctypes.c_longlong)]
    lib.pd_tcpstore_add_unique.restype = ctypes.c_int
    lib.pd_tcpstore_add_unique.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.pd_tcpstore_compare_set.restype = ctypes.c_longlong
    lib.pd_tcpstore_compare_set.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
    lib.pd_tcpstore_heartbeat.restype = ctypes.c_int
    lib.pd_tcpstore_heartbeat.argtypes = [ctypes.c_void_p,
                                          ctypes.c_longlong]
    lib.pd_tcpstore_deregister.restype = ctypes.c_int
    lib.pd_tcpstore_deregister.argtypes = [ctypes.c_void_p,
                                           ctypes.c_longlong]
    lib.pd_tcpstore_dead_ranks.restype = ctypes.c_longlong
    lib.pd_tcpstore_dead_ranks.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong]
    lib.pd_tcpstore_wait.restype = ctypes.c_int
    lib.pd_tcpstore_wait.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int, ctypes.c_longlong]
    lib.pd_tcpstore_check.restype = ctypes.c_int
    lib.pd_tcpstore_check.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int]
    lib.pd_tcpstore_delete.restype = ctypes.c_int
    lib.pd_tcpstore_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
    lib.pd_tcpstore_num_keys.restype = ctypes.c_longlong
    lib.pd_tcpstore_num_keys.argtypes = [ctypes.c_void_p]
    # -- HA plane --
    lib.pd_tcpstore_server_set_standby.argtypes = [ctypes.c_void_p]
    lib.pd_tcpstore_server_add_replica.restype = ctypes.c_int
    lib.pd_tcpstore_server_add_replica.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.pd_tcpstore_server_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.pd_tcpstore_server_num_replicas.restype = ctypes.c_longlong
    lib.pd_tcpstore_server_num_replicas.argtypes = [ctypes.c_void_p]
    lib.pd_tcpstore_set_op_deadline.argtypes = [ctypes.c_void_p,
                                                ctypes.c_longlong]
    lib.pd_tcpstore_last_timed_out.restype = ctypes.c_int
    lib.pd_tcpstore_last_timed_out.argtypes = [ctypes.c_void_p]
    lib.pd_tcpstore_epoch_info.restype = ctypes.c_int
    lib.pd_tcpstore_epoch_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.pd_tcpstore_probe.restype = ctypes.c_int
    lib.pd_tcpstore_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.pd_tcpstore_promote.restype = ctypes.c_int
    lib.pd_tcpstore_promote.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.pd_tcpstore_journal_tail.restype = ctypes.c_longlong
    lib.pd_tcpstore_journal_tail.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p,
        ctypes.c_longlong]
    _lib = lib
    return lib


def probe_endpoint(host, port, timeout=1.0):
    """One-shot (epoch, seqno, role) probe of a store endpoint, or None
    when it is unreachable OR stalled — the probe's recv deadline covers
    the SIGSTOPped-server case, where the kernel still completes the TCP
    handshake but nothing ever answers."""
    lib = _load()
    e = ctypes.c_longlong(0)
    s = ctypes.c_longlong(0)
    r = ctypes.c_int(0)
    rc = lib.pd_tcpstore_probe(host.encode(), int(port),
                               int(timeout * 1000), ctypes.byref(e),
                               ctypes.byref(s), ctypes.byref(r))
    if rc != 0:
        return None
    return int(e.value), int(s.value), int(r.value)


def promote_endpoint(host, port, peers=(), timeout=10.0):
    """Promote the standby at host:port to primary (epoch+1), handing it
    ``peers`` (iterable of "host:port") to adopt as its own standbys.
    Idempotent on an already-promoted node. Returns its epoch after the
    call, or None when unreachable."""
    lib = _load()
    peers_b = ",".join(peers).encode()
    e = ctypes.c_longlong(0)
    rc = lib.pd_tcpstore_promote(host.encode(), int(port), peers_b,
                                 len(peers_b), int(timeout * 1000),
                                 ctypes.byref(e))
    if rc != 0:
        return None
    return int(e.value)


# store-client telemetry: every round-trip lands in a latency
# histogram labeled by op; failures (connection loss / op-deadline
# expiry — NOT a key miss or a healthy-server wait timeout) count per
# op. In-process registry updates only: ~1µs against ms round-trips.
STORE_OP_MS = _obs_metrics.histogram(
    "store_op_ms", help="TCPStore client round-trip latency per op (ms)")
STORE_OP_ERRORS = _obs_metrics.counter(
    "store_op_errors_total",
    help="TCPStore ops failing with connection loss or StoreOpTimeout")


def _observed(op):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            except StoreOpTimeout:
                STORE_OP_ERRORS.inc(op=op, error="op_timeout")
                raise
            except RuntimeError:
                STORE_OP_ERRORS.inc(op=op, error="connection")
                raise
            finally:
                STORE_OP_MS.observe((time.perf_counter() - t0) * 1e3,
                                    op=op)
        return wrapper
    return deco


class TCPStore:
    """paddle-compatible TCPStore.

    is_master=True additionally hosts the C++ server in-process (rank 0);
    every instance holds a client connection. port=0 picks an ephemeral
    port (read back via .port — useful in tests)."""

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=30.0, rank=None, op_timeout=None):
        lib = _load()
        self._lib = lib
        self._server = None
        self.world_size = world_size
        self.rank = rank  # enables idempotent (retry-safe) barrier arrivals
        self.timeout = float(timeout)
        # per-op recv deadline (seconds; 0 disables): a hung server
        # surfaces as StoreOpTimeout instead of an unbounded block
        self.op_timeout = (default_op_timeout() if op_timeout is None
                           else float(op_timeout))
        if is_master:
            self._server = lib.pd_tcpstore_server_start(int(port))
            if not self._server:
                raise RuntimeError(f"TCPStore: cannot listen on port {port}")
            port = lib.pd_tcpstore_server_port(self._server)
            host = "127.0.0.1" if host in ("", "0.0.0.0") else host
        self.host, self.port = host, int(port)
        self._client = lib.pd_tcpstore_connect(
            host.encode(), self.port, int(timeout * 1000))
        if not self._client:
            raise TimeoutError(
                f"TCPStore: cannot connect to {host}:{self.port} "
                f"within {timeout}s")
        if self.op_timeout > 0:
            lib.pd_tcpstore_set_op_deadline(
                self._client, int(self.op_timeout * 1000))

    def clone(self):
        """Fresh connection to the same server (same rank/world): detector
        threads use this so their heartbeats never queue behind a blocking
        wait() on the main connection's mutex."""
        return TCPStore(host=self.host, port=self.port,
                        world_size=self.world_size, rank=self.rank,
                        timeout=self.timeout, op_timeout=self.op_timeout)

    def _io_error(self, op):
        """Classify the last failed round-trip: recv-deadline expiry (hung
        server) raises StoreOpTimeout, anything else the legacy
        connection-lost RuntimeError."""
        if self._lib.pd_tcpstore_last_timed_out(self._client):
            raise StoreOpTimeout(
                f"TCPStore.{op} exceeded the {self.op_timeout}s op "
                f"deadline ({OP_TIMEOUT_ENV}): server hung or stalled")
        raise RuntimeError(f"TCPStore.{op} failed (connection lost)")

    # -- kv API (reference semantics) ---------------------------------------
    @_observed("set")
    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        k = key.encode()
        if self._lib.pd_tcpstore_set(self._client, k, len(k), value,
                                     len(value)) != 0:
            self._io_error("set")

    @_observed("get")
    def get(self, key):
        k = key.encode()
        buf_len = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(buf_len)
            n = self._lib.pd_tcpstore_get(self._client, k, len(k), buf,
                                          buf_len)
            if n == -3:
                buf_len *= 16
                continue
            if n == -1:
                raise KeyError(key)
            if n < 0:
                self._io_error("get")
            return buf.raw[:n]

    @_observed("add")
    def add(self, key, amount=1):
        k = key.encode()
        out = ctypes.c_longlong(0)
        rc = self._lib.pd_tcpstore_add2(self._client, k, len(k),
                                        int(amount), ctypes.byref(out))
        if rc != 0:
            self._io_error("add")
        return int(out.value)

    @_observed("heartbeat")
    def heartbeat(self, rank=None):
        """Record liveness for ``rank`` (defaults to this store's rank).
        The SERVER timestamps with its monotonic clock — no cross-host
        clock skew in the staleness math (SURVEY.md §5.3)."""
        r = self.rank if rank is None else rank
        if r is None:
            raise ValueError("heartbeat needs a rank (pass rank= or "
                             "construct TCPStore with rank=)")
        if self._lib.pd_tcpstore_heartbeat(self._client, int(r)) != 0:
            self._io_error("heartbeat")

    @_observed("dead_ranks")
    def dead_ranks(self, timeout=10.0, max_ranks=4096):
        """Ranks that have heartbeated at least once but not within
        ``timeout`` seconds (by the server's clock). Gracefully
        deregistered ranks are not reported."""
        while True:
            buf = (ctypes.c_longlong * max_ranks)()
            n = self._lib.pd_tcpstore_dead_ranks(
                self._client, int(timeout * 1000), buf, max_ranks)
            if n < 0:
                self._io_error("dead_ranks")
            if n <= max_ranks:
                return sorted(int(buf[i]) for i in range(n))
            max_ranks = int(n)  # true count exceeded the buffer: re-query

    @_observed("deregister")
    def deregister(self, rank=None):
        """Gracefully stop liveness tracking for ``rank`` (elastic
        scale-down must not leave phantom dead ranks)."""
        r = self.rank if rank is None else rank
        if r is None:
            raise ValueError("deregister needs a rank")
        if self._lib.pd_tcpstore_deregister(self._client, int(r)) != 0:
            self._io_error("deregister")

    @_observed("compare_set")
    def compare_set(self, key, expected, desired):
        """Atomic compare-and-swap: set ``key`` to ``desired`` iff its
        current value equals ``expected``. ``expected=""`` ALSO matches
        an absent key (use it to initialize counters race-free) — i.e.
        absent and present-but-empty are deliberately equivalent, the
        c10d Store::compareSet contract. Returns
        ``(value_after_op, swapped)``; on a lost race ``value_after_op``
        is the winner's value, so the loser re-reads in the same
        round-trip. This is the primitive elastic membership uses for
        generation bumps: of N agents racing ``compare_set(gen, g, g+1)``
        exactly one swaps.

        NOTE: not a read — a call is one CAS attempt. The reply buffer is
        64 KiB; larger values raise instead of silently retrying (a retry
        would re-run the CAS)."""
        if isinstance(expected, str):
            expected = expected.encode()
        if isinstance(desired, str):
            desired = desired.encode()
        k = key.encode()
        buf_len = 1 << 16
        buf = ctypes.create_string_buffer(buf_len)
        swapped = ctypes.c_int(0)
        n = self._lib.pd_tcpstore_compare_set(
            self._client, k, len(k), expected, len(expected),
            desired, len(desired), buf, buf_len, ctypes.byref(swapped))
        if n == -3:
            raise RuntimeError(
                "TCPStore.compare_set: value exceeds the 64KiB reply "
                "buffer (membership keys are expected to be tiny)")
        if n < 0:
            self._io_error("compare_set")
        return buf.raw[:int(n)], bool(swapped.value)

    @_observed("add_unique")
    def add_unique(self, member_key, counter_key):
        """Atomically: if member_key is absent, set it and increment
        counter_key — one server-side critical section, one round-trip.
        Returns (counter_value, newly_added)."""
        m, c = member_key.encode(), counter_key.encode()
        count = ctypes.c_longlong(0)
        newly = ctypes.c_int(0)
        rc = self._lib.pd_tcpstore_add_unique(
            self._client, m, len(m), c, len(c),
            ctypes.byref(count), ctypes.byref(newly))
        if rc != 0:
            self._io_error("add_unique")
        return int(count.value), bool(newly.value)

    @_observed("wait")
    def wait(self, keys, timeout=None):
        """Block until every key exists. ``timeout=None`` no longer means
        forever: it defaults to the op deadline (``PADDLE_STORE_OP_TIMEOUT``,
        0 disables) so a hung store surfaces as a TimeoutError in agent
        poll loops instead of an unbounded hang. The recv leg is bounded
        at timeout+5s regardless, so a server that DIES mid-wait raises
        StoreOpTimeout instead of parking the caller."""
        if isinstance(keys, str):
            keys = [keys]
        if timeout is None:
            timeout = self.op_timeout if self.op_timeout > 0 else None
        ms = -1 if timeout is None else int(timeout * 1000)
        for key in keys:
            k = key.encode()
            rc = self._lib.pd_tcpstore_wait(self._client, k, len(k), ms)
            if rc == 0:
                raise TimeoutError(f"TCPStore.wait timed out on '{key}'")
            if rc < 0:
                self._io_error("wait")

    @_observed("check")
    def check(self, key):
        return self._lib.pd_tcpstore_check(self._client, key.encode(),
                                           len(key.encode())) == 1

    @_observed("delete_key")
    def delete_key(self, key):
        k = key.encode()
        return self._lib.pd_tcpstore_delete(self._client, k, len(k)) == 1

    @_observed("num_keys")
    def num_keys(self):
        return int(self._lib.pd_tcpstore_num_keys(self._client))

    # -- HA plane -------------------------------------------------
    def ha_info(self):
        """(epoch, seqno, role) of the CONNECTED server — role is one of
        ROLE_PRIMARY / ROLE_STANDBY / ROLE_FENCED."""
        e = ctypes.c_longlong(0)
        s = ctypes.c_longlong(0)
        r = ctypes.c_int(0)
        if self._lib.pd_tcpstore_epoch_info(
                self._client, ctypes.byref(e), ctypes.byref(s),
                ctypes.byref(r)) != 0:
            self._io_error("ha_info")
        return int(e.value), int(s.value), int(r.value)

    def journal_tail(self, from_seqno=0):
        """Debug/tooling view of the server's op journal past
        ``from_seqno``: {"epoch": E, "entries": [{"seq", "writes":
        [{"key": bytes, "val": bytes | None}]}]}. Raises LookupError when
        retention trimmed past from_seqno (a snapshot is needed)."""
        import json
        buf_len = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(buf_len)
            n = self._lib.pd_tcpstore_journal_tail(
                self._client, int(from_seqno), buf, buf_len)
            if n == -3:
                buf_len *= 8
                continue
            if n == -4:
                raise LookupError(
                    f"journal trimmed past seqno {from_seqno}: catch up "
                    "via snapshot")
            if n < 0:
                self._io_error("journal_tail")
            raw = json.loads(buf.raw[:int(n)].decode())
            return {"epoch": raw["epoch"], "entries": [
                {"seq": e["seq"], "writes": [
                    {"key": bytes.fromhex(w["key_hex"]),
                     "val": (bytes.fromhex(w["val_hex"])
                             if "val_hex" in w else None)}
                    for w in e["writes"]]}
                for e in raw["entries"]]}

    def _require_server(self, what):
        if not getattr(self, "_server", None):
            raise ValueError(f"{what} requires is_master=True (this "
                             "instance does not host the server)")

    def server_set_standby(self):
        """Make the hosted server a STANDBY: it refuses data ops (clients
        that connect re-probe elsewhere) and waits for a primary to sync
        it via snapshot/journal replay."""
        self._require_server("server_set_standby")
        self._lib.pd_tcpstore_server_set_standby(self._server)

    def server_add_replica(self, host, port, timeout=5.0):
        """Primary side: attach the standby at host:port — sync it (full
        snapshot, or journal-tail replay when retention covers its lag)
        and mirror every subsequent mutating op to it synchronously
        BEFORE acking clients. Returns True on success."""
        self._require_server("server_add_replica")
        return self._lib.pd_tcpstore_server_add_replica(
            self._server, host.encode(), int(port),
            int(timeout * 1000)) == 0

    def server_info(self):
        """(epoch, seqno, role) of the HOSTED server (no round-trip)."""
        self._require_server("server_info")
        e = ctypes.c_longlong(0)
        s = ctypes.c_longlong(0)
        r = ctypes.c_int(0)
        self._lib.pd_tcpstore_server_info(self._server, ctypes.byref(e),
                                          ctypes.byref(s), ctypes.byref(r))
        return int(e.value), int(s.value), int(r.value)

    def server_num_replicas(self):
        self._require_server("server_num_replicas")
        return int(self._lib.pd_tcpstore_server_num_replicas(self._server))

    # -- rendezvous helpers --------------------------------------------------
    # timeout=None delegates to wait(), whose None default IS the bounded
    # PADDLE_STORE_OP_TIMEOUT op deadline (0 opts out explicitly)
    def barrier(self, name="barrier", timeout=None):
        """All world_size participants block until everyone arrives.

        Reusable and restart-safe: state lives on the SERVER, not in
        instance memory, so a participant that reconnects with a fresh
        TCPStore continues at the cluster's current generation instead of
        resetting to 0 and sailing through stale done-keys.

        With ``rank`` set on the store, arrival is one ATOMIC
        mark-and-count (add_unique), so a retried barrier call (timeout,
        restart) is idempotent — it re-joins its pending generation instead
        of double-counting, and there is no crash window between "mark
        arrived" and "count arrival". Without a rank, arrivals are counted
        anonymously (reference TCPStore semantics) and a retry after a
        timeout can desync the round — pass rank for elastic/retry use."""
        if self.rank is not None:
            pending = getattr(self, "_bar_pending", None)
            if pending is None:
                pending = self._bar_pending = {}
            gen = pending.get(name)
            if gen is None:
                # join the cluster's current generation; a same-instance
                # retry re-enters the generation it already arrived in
                # (its wait may have raced the release)
                gen = self.add(f"__b/{name}/gen", 0)
            pending[name] = gen
            count, _ = self.add_unique(
                f"__b/{name}/{gen}/arrived/{self.rank}",
                f"__b/{name}/{gen}/count")
            if count >= self.world_size:
                # ANY observer of completion may release (the completing
                # rank could die between arriving and releasing); the
                # generation bump is itself an add_unique so it happens once
                self.add_unique(f"__b/{name}/{gen}/advanced",
                                f"__b/{name}/gen")
                self.set(f"__b/{name}/{gen}/done", b"1")
            self.wait([f"__b/{name}/{gen}/done"], timeout=timeout)
            pending[name] = None
            return
        arrival = self.add(f"__b/{name}/round", 1)
        gen = (arrival - 1) // self.world_size
        count = self.add(f"__b/{name}/{gen}/count", 1)
        if count >= self.world_size:
            self.set(f"__b/{name}/{gen}/done", b"1")
        self.wait([f"__b/{name}/{gen}/done"], timeout=timeout)

    def close(self):
        if getattr(self, "_client", None):
            self._lib.pd_tcpstore_close(self._client)
            self._client = None
        if getattr(self, "_server", None):
            self._lib.pd_tcpstore_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
