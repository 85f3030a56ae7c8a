"""Serving-fleet protocol: the key schema router and replicas share on
the membership store (a copy of
``paddle_tpu/inference/serving/fleet.py``: both packages speak it).

The fleet control plane is the SAME store the elastic trainers use —
a serving world is one more tenant under its own ``__srv`` prefix.
Request/response payloads also ride the store as per-replica mailboxes:
that keeps every router/replica decision on the substrate seam, so
tools/paddlecheck explores the REAL drain/failover code
(``models/serving_router.py``) exactly like it explores the agent loop.
A production data plane would move token streaming to direct RPC; the
routing, drain and failover DECISIONS — what this module encodes and
the model checker proves — are transport-independent (stated boundary,
docs/SERVING.md).

Schema (all keys under ``__srv``):

- ``gen``                 serving generation (CAS counter; bumps on
                          membership change or model roll)
- ``g{g}/bundle``         JSON {path, sha256}: the model bundle this
                          generation serves — the digest GATES the load
- ``nrep``                replica-id counter (``add``)
- ``r{i}/info``           JSON {name, generation, bundle_sha, pid}
- ``r{i}/state``          serving | draining | stopped | dead
- ``r{i}/occ``            JSON occupancy gauge {free_pages, running,
                          waiting, pulled, steps}
- ``r{i}/qn``             mailbox depth counter; ``r{i}/q/{n}`` holds
                          the rid routed into slot n
- ``r{i}/drained``        set by a drained replica: its pull cursor —
                          mailbox entries >= it were never admitted and
                          are the router's to re-route
- ``rid``                 request-id counter
- ``req/{rid}``           JSON request payload {prompt, max_new_tokens,
                          eos_token_id, deadline_s}
- ``done/{rid}``          JSON completion {status, tokens, replica,
                          generation} — committed by ``compare_set``
                          from empty, so EXACTLY ONE completion wins
                          per rid however many replicas race it

Liveness: replica ``i`` heartbeats as rank ``REPLICA_RANK_BASE + i`` —
a disjoint rank space from the elastic agents' node ids, so one store
can host both planes.
"""
from __future__ import annotations

import json

PREFIX = "__srv"

# replica liveness ranks live far above any elastic agent's node id so
# both planes can share one store's heartbeat table
REPLICA_RANK_BASE = 1 << 20

STATE_SERVING = b"serving"
STATE_DRAINING = b"draining"
STATE_STOPPED = b"stopped"
STATE_DEAD = b"dead"

ST_OK = "ok"
ST_TIMEOUT = "timeout"
ST_TOO_LARGE = "too_large"
# admission control / load shedding refusal: the request was never
# accepted (or was shed from a waiting queue before any token was
# committed) — clients may retry after the hint in ``retry_after_s``
ST_OVERLOADED = "overloaded"


def k_gen():
    return f"{PREFIX}/gen"


def k_bundle(gen):
    return f"{PREFIX}/g{gen}/bundle"


def k_nrep():
    return f"{PREFIX}/nrep"


def k_info(i):
    return f"{PREFIX}/r{i}/info"


def k_state(i):
    return f"{PREFIX}/r{i}/state"


def k_occ(i):
    return f"{PREFIX}/r{i}/occ"


def k_qn(i):
    return f"{PREFIX}/r{i}/qn"


def k_q(i, n):
    return f"{PREFIX}/r{i}/q/{n}"


def k_drained(i):
    return f"{PREFIX}/r{i}/drained"


def k_rid():
    return f"{PREFIX}/rid"


def k_req(rid):
    return f"{PREFIX}/req/{rid}"


def k_done(rid):
    return f"{PREFIX}/done/{rid}"


def current_generation(store):
    """Read (initializing race-free on first touch) the serving
    generation — the same plain-get-first shape as the elastic
    rendezvous counter: this runs in every poll loop."""
    try:
        return int(store.get(k_gen()))
    except KeyError:
        val, _ = store.compare_set(k_gen(), "", "0")
        return int(val)


def bump_generation(store, from_gen):
    """CAS the serving generation past ``from_gen``; exactly one of N
    racing bumpers wins. Returns (generation_now, won)."""
    val, won = store.compare_set(k_gen(), str(from_gen), str(from_gen + 1))
    return int(val), won


def publish_bundle(store, gen, path, sha256):
    """Publish the model bundle generation ``gen`` serves. Replicas
    verify their loaded bundle's digest against ``sha256`` before
    admitting any work — the checkpoint-digest gate applied to
    model rolls."""
    store.set(k_bundle(gen), json.dumps({"path": str(path),
                                         "sha256": str(sha256)}))


def read_bundle(store, gen):
    """The bundle published AT ``gen`` exactly, or None."""
    try:
        return json.loads(store.get(k_bundle(gen)).decode())
    except KeyError:
        return None


def active_bundle(store, gen):
    """The bundle generation ``gen`` SERVES: the most recent publish at
    or below it. Membership-only bumps (a replica died or drained —
    no new model) inherit the previous generation's bundle; without
    this walk-back, a bump past the last publish would let a
    stale-bundle replica join unchecked (found by the model-roll
    end-to-end drive)."""
    for g in range(int(gen), -1, -1):
        b = read_bundle(store, g)
        if b is not None:
            return b
    return None


def post_done(store, rid, payload):
    """Commit a completion for ``rid``. compare_set from the empty
    value means the FIRST completion wins and every later attempt
    (a drained replica racing the router's re-route, a router-side
    timeout racing a late replica) is discarded — 'every admitted
    request completes on exactly one replica' is enforced here, not
    hoped for. Returns True when this payload won."""
    _, won = store.compare_set(k_done(rid), "", json.dumps(payload))
    return won


def read_done(store, rid):
    """The committed completion for ``rid`` or None."""
    try:
        return json.loads(store.get(k_done(rid)).decode())
    except KeyError:
        return None


def read_state(store, i):
    try:
        return store.get(k_state(i))
    except KeyError:
        return None


def read_occ(store, i):
    try:
        return json.loads(store.get(k_occ(i)).decode())
    except KeyError:
        return None
