"""Store-backed versioned rendezvous for elastic membership (counterpart:
``paddle_tpu/distributed/elastic/rendezvous.py``; upstream's elastic
rendezvous).

The protocol keeps every piece of state on the ``TCPStore`` server, none in
an agent's memory, so any agent can die at any point. Its keys are the
reference's, key for key, so agents of both packages can share one store:

- ``__el/gen`` holds the cluster's generation, a counter that only grows.
  Every change of membership (a peer's death, a node joining, a local
  trainer failure) advances it by ``compare_set(gen, g, g + 1)``: of the
  agents racing one bump exactly one wins, and the losers read the winner's
  value in the same round trip.
- A node joins generation ``g`` by ``add_unique`` on
  ``__el/g{g}/member/{node}`` with the counter ``__el/g{g}/count``, then
  claims the lowest free ``__el/g{g}/arrival/{slot}`` by ``compare_set``.
  Slots are the node ranks of the new world.
- The node in slot 0 closes the round: once ``count >= max_nnodes``, or
  ``count >= min_nnodes`` and ``last_call`` seconds have passed since, it
  publishes ``__el/g{g}/world`` (the members in slot order and a fresh
  trainer coordinator address). Everyone else waits for that key.
- A node that finds the current generation closed without it (a host
  coming back) bumps the generation, and the sitting members' agents
  rendezvous again: that is scale-out. A survivor that sees a peer's
  heartbeat go stale bumps it: scale-in.
"""
from __future__ import annotations

import json
from collections import namedtuple

from ...observability import trace as _obs_trace
from ..substrate import SYSTEM_CLOCK

RendezvousInfo = namedtuple(
    "RendezvousInfo", ["generation", "rank", "nnodes", "members",
                       "pod_master"])


def _default_pod_master():
    from ..env import find_free_port
    return f"127.0.0.1:{find_free_port()}"


class ElasticRendezvous:
    """Versioned min/max-nnodes rendezvous over a ``TCPStore``.

    ``node_name`` must be unique per agent process life (a host that comes
    back gets a fresh name); ``ElasticAgent`` derives it from a node id the
    store hands out. ``pod_master_factory`` gives the generation's trainer
    coordinator address and runs only on the node that closes the round;
    the default takes a free port on localhost (every node on one host)."""

    def __init__(self, store, node_name, min_nnodes, max_nnodes,
                 timeout=120.0, last_call=1.0, poll=0.05, prefix="__el",
                 pod_master_factory=None, clock=None):
        if min_nnodes < 1 or max_nnodes < min_nnodes:
            raise ValueError(
                f"need 1 <= min_nnodes <= max_nnodes, got "
                f"{min_nnodes}/{max_nnodes}")
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.store = store
        self.node_name = node_name
        self.min_nnodes = min_nnodes
        self.max_nnodes = max_nnodes
        self.timeout = timeout
        self.last_call = last_call
        self.poll = poll
        self.prefix = prefix
        self.pod_master_factory = pod_master_factory or _default_pod_master

    # -- the generation counter ----------------------------------------------
    def current_generation(self):
        """The cluster's generation; the first touch initializes it to 0
        with a compare-and-set, every later read is a plain get."""
        try:
            return int(self.store.get(f"{self.prefix}/gen"))
        except KeyError:
            val, _ = self.store.compare_set(f"{self.prefix}/gen", "", "0")
            return int(val)

    def bump_generation(self, from_gen):
        """Advance the generation past ``from_gen``: of the agents racing
        the same bump exactly one wins; a loser sees the winner's (or a
        later) value. Returns (generation_now, won)."""
        val, won = self.store.compare_set(
            f"{self.prefix}/gen", str(from_gen), str(from_gen + 1))
        _obs_trace.event("elastic.generation_bump", node=self.node_name,
                         from_gen=from_gen, to_gen=int(val), won=won)
        return int(val), won

    # -- one round ------------------------------------------------------------
    def _world_key(self, gen):
        return f"{self.prefix}/g{gen}/world"

    def _read_world(self, gen):
        return json.loads(self.store.get(self._world_key(gen)).decode())

    def _register(self, gen):
        """Join round ``gen``; returns this node's arrival slot.

        Every step may be retried: a store client that follows a failover
        can commit an op whose acknowledgement was lost. So a slot is
        claimed by ``compare_set`` on its ``arrival/{slot}`` key, which
        records the claim itself: a retry finds this node's name there and
        returns the same slot. A fresh registration was the ``count``-th
        member, so the slots below ``count - 1`` are taken and the claim
        starts at ``count - 1``; a retried one learned no count and scans
        from 0."""
        count, newly = self.store.add_unique(
            f"{self.prefix}/g{gen}/member/{self.node_name}",
            f"{self.prefix}/g{gen}/count")
        slot = max(int(count) - 1, 0) if newly else 0
        while True:
            val, won = self.store.compare_set(
                f"{self.prefix}/g{gen}/arrival/{slot}", "",
                self.node_name)
            if won or val.decode() == self.node_name:
                return slot
            slot += 1

    def _close_round(self, gen, deadline):
        """The slot-0 node's duty: wait for min/max nnodes, then publish
        the world. Written once, and given up if the generation moves on."""
        min_reached_at = None
        while self.clock.monotonic() < deadline:
            if self.store.check(self._world_key(gen)):
                return
            if self.current_generation() != gen:
                return
            count = self.store.add(f"{self.prefix}/g{gen}/count", 0)
            now = self.clock.monotonic()
            if count >= self.min_nnodes and min_reached_at is None:
                min_reached_at = now
            if count >= self.max_nnodes or (
                    min_reached_at is not None
                    and now - min_reached_at >= self.last_call):
                nnodes = min(int(count), self.max_nnodes)
                members = []
                for slot in range(nnodes):
                    k = f"{self.prefix}/g{gen}/arrival/{slot}"
                    # a counted member may not have named its slot yet:
                    # wait in short slices (a long wait holds the
                    # connection's lock, which the detector's bump needs)
                    while not self.store.check(k):
                        if self.clock.monotonic() >= deadline or \
                                self.current_generation() != gen:
                            # a registrant died between counting and
                            # naming itself: the death's bump (or the
                            # deadline) moves everyone to a new round
                            return
                        try:
                            self.store.wait([k], timeout=0.25)
                        except TimeoutError:
                            pass
                    members.append(self.store.get(k).decode())
                self.store.set(self._world_key(gen), json.dumps({
                    "generation": gen, "members": members,
                    "pod_master": self.pod_master_factory()}))
                return
            self.clock.sleep(self.poll)

    def next_rendezvous(self, timeout=None):
        """Block until a round completes with this node in it; returns
        ``RendezvousInfo(generation, rank, nnodes, members, pod_master)``.
        Joins the open round, asks for a new one (a bump) when the current
        one closed without this node, and follows bumps while it waits.
        Raises ``TimeoutError`` when no round closes within ``timeout``
        (default: the constructor's)."""
        deadline = self.clock.monotonic() + (timeout or self.timeout)
        while self.clock.monotonic() < deadline:
            gen = self.current_generation()
            if self.store.check(self._world_key(gen)):
                world = self._read_world(gen)
                if self.node_name in world["members"]:
                    return self._build_info(gen, world)
                self.bump_generation(gen)
                continue
            slot = self._register(gen)
            if slot == 0:
                self._close_round(gen, deadline)
            while self.clock.monotonic() < deadline:
                try:
                    self.store.wait([self._world_key(gen)], timeout=0.25)
                    break
                except TimeoutError:
                    if self.current_generation() != gen:
                        break
            if self.store.check(self._world_key(gen)):
                world = self._read_world(gen)
                if self.node_name in world["members"]:
                    return self._build_info(gen, world)
                self.bump_generation(gen)
        raise TimeoutError(
            f"rendezvous did not complete within {timeout or self.timeout}s"
            f" (node={self.node_name}, min_nnodes={self.min_nnodes})")

    def _build_info(self, gen, world):
        members = world["members"]
        return RendezvousInfo(
            generation=gen, rank=members.index(self.node_name),
            nnodes=len(members), members=list(members),
            pod_master=world["pod_master"])
