"""Injectable substrate for the elastic control plane (a copy of
``paddle_tpu/distributed/substrate.py``). The protocol decision logic in
the reference's ``store_ha.py`` /
``elastic/rendezvous.py`` / ``elastic/agent.py`` reads time, probes
endpoints, connects stores, takes locks and spawns watcher threads ONLY
through this interface, so the exact code that runs in production is the
code `tools/paddlecheck` explores under a controlled scheduler with a
virtual clock and an in-memory simulated store.

Production behavior is unchanged by construction: every entry point
delegates to the same primitive the call site used before the refactor
(``time.monotonic``/``time.sleep``, ``probe_endpoint``/
``promote_endpoint``/``TCPStore``, ``threading.RLock``/``Thread``), and
``NATIVE_SUBSTRATE`` is the default nobody has to pass.

The checker-side counterpart (``tools/paddlecheck/simsubstrate.py``)
implements the same surface over a deterministic scheduler: ``sleep``
advances a virtual clock, ``probe``/``connect``/``promote`` hit the
simulated replicated store (with crash/stall injection points at every
mirror/promote boundary), ``lock`` is a cooperative lock the scheduler
can interleave, and ``spawn`` creates a scheduler-controlled task.
"""
from __future__ import annotations

import hashlib
import os
import random
import threading
import time


def stable_seed(text):
    """Hash ``text`` to a 64-bit PRNG seed that is stable across
    processes and Python runs (``hash()`` is salted; this must not be).
    Shared by the production and checker substrates so the SAME naming
    scheme yields the same jitter stream under a pinned seed."""
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "big")


class SystemClock:
    """Production time plane: steady clock + real sleeps. ``monotonic``
    (never ``time.time``) on purpose — deadlines here must be immune to
    wall-clock steps."""

    monotonic = staticmethod(time.monotonic)
    monotonic_ns = staticmethod(time.monotonic_ns)
    sleep = staticmethod(time.sleep)

    @staticmethod
    # pure pass-through of the CALLER'S timeout to Event.wait: every substrate
    # call site (agent watcher, detector poll) passes its own bounded interval;
    # the substrate must not impose a second deadline policy
    def wait(event, timeout=None):
        """``threading.Event.wait`` through the clock plane, so a
        simulated clock can turn event-waits into virtual time instead
        of parking a real thread."""
        return event.wait(timeout)


SYSTEM_CLOCK = SystemClock()


class Substrate:
    """The production substrate: native store transport + system clock +
    real threads. Import sites keep working untouched; the checker
    passes its own instance with the same duck type."""

    clock = SYSTEM_CLOCK

    # -- store transport ----------------------------------------------------
    def probe(self, host, port, timeout=1.0):
        from .store import probe_endpoint
        return probe_endpoint(host, port, timeout=timeout)

    def promote(self, host, port, peers=(), timeout=10.0):
        from .store import promote_endpoint
        return promote_endpoint(host, port, peers=peers, timeout=timeout)

    def connect(self, host, port, world_size=1, rank=None, timeout=30.0,
                op_timeout=None):
        from .store import TCPStore
        return TCPStore(host=host, port=port, world_size=world_size,
                        rank=rank, timeout=timeout, op_timeout=op_timeout)

    # -- randomness plane ---------------------------------------------------
    def rng(self, name=""):
        """Deterministic-seeded PRNG stream for decorrelation jitter
        (the ReplicatedStore failover-reprobe backoff). Each call site
        passes a stable ``name`` so distinct clients draw independent
        streams; the base seed comes from ``PADDLE_BACKOFF_SEED`` when
        pinned (reproducible runs) and the process id otherwise. The
        checker substrate overrides this with a fixed per-model seed so
        paddlecheck replays stay bit-for-bit."""
        base = os.environ.get("PADDLE_BACKOFF_SEED") or str(os.getpid())
        return random.Random(stable_seed(f"{base}:{name}"))

    # -- concurrency plane --------------------------------------------------
    def lock(self):
        """Reentrant lock guarding cross-thread state swaps (the
        ReplicatedStore failover re-locate section)."""
        return threading.RLock()

    def spawn(self, name, fn):
        """Start a daemon watcher thread; returns the join()-able
        handle. The checker's version returns a scheduler task whose
        join() blocks in virtual time."""
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        return t


NATIVE_SUBSTRATE = Substrate()
