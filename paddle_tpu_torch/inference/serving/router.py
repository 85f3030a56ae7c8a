"""Serving-fleet request router over the HA membership store (counterpart:
``paddle_tpu/inference/serving/router.py``, whose decisions this copy
makes on the same store contents).

The router discovers live ``ServingReplica`` members from the store,
health-checks them through the same heartbeat liveness table the
elastic plane uses (`dead_ranks` at a replica-rank offset), routes each
request to the serving replica with the most free KV pages (the
occupancy gauge replicas publish every loop), and owns the two
departure paths the model checker proves:

- **graceful drain** (``drain(i)`` — scale-in or model roll): CAS the
  replica's state ``serving -> draining``; the replica stops admitting,
  finishes its in-flight requests and posts its pull cursor; the router
  re-routes the never-admitted mailbox tail, then bumps the serving
  generation so the departed member is fenced out of the world.
- **failure** (heartbeat staleness): mark the corpse ``dead``, re-route
  every one of its assigned requests that has no committed completion
  (re-prefill on the survivor is exact — the eviction machinery —
  so re-routed greedy tokens are bit-identical to an unfailed run), and
  bump the generation. The ``done`` CAS makes the race with a
  not-quite-dead replica safe: exactly one completion wins per rid.

Per-request deadlines are honored at every hop: at submit, at route, at
RE-ROUTE (the re-queue path must not make a request immortal), and in
the pending sweep — an overdue request completes with the typed
``timeout`` status instead of waiting forever.

Spans/events (docs/OBSERVABILITY.md): ``serve.route`` per routing
decision (``requeue`` attr marks re-routes), ``serve.drain`` around a
departure (graceful or death), ``serve.replica_death`` at the
staleness verdict.

The router is torch-free and engine-free: it talks only to the store, so
paddlecheck's ``serving_router`` model explores this exact code.
"""
from __future__ import annotations

import json
import time

from ...distributed.substrate import NATIVE_SUBSTRATE
from ...observability import metrics, trace
from . import fleet
# the SAME hash-chain code the prefix cache keys pages with:
# the router recomputes a prompt's chain keys with the identical
# function, so the affinity digest can never silently drift from the
# cache's keys (test-pinned bit-parity). prefix_cache is stdlib-only,
# so the router stays torch-free.
from .prefix_cache import _chunk_keys

ROUTED = metrics.counter(
    "serving_router_routed", "requests routed to a replica")
AFFINITY_ROUTED = metrics.counter(
    "serving_router_affinity_routed", "requests routed to the replica "
    "already holding their prefix pages")
REQUEUED = metrics.counter(
    "serving_router_requeued", "requests re-routed off a departed replica")
TIMEOUTS = metrics.counter(
    "serving_router_timeouts", "requests completed with the typed "
    "timeout status by the router")
OVERLOADED = metrics.counter(
    "serving_router_overloaded", "requests refused with the typed "
    "overloaded status by the router's admission control")
FLEET_SIZE = metrics.gauge(
    "serving_fleet_replicas", "replicas in the serving state")


class ReplicaView:
    """One discovery snapshot of a replica."""

    __slots__ = ("i", "state", "info", "occ")

    def __init__(self, i, state, info, occ):
        self.i = i
        self.state = state
        self.info = info or {}
        self.occ = occ or {}

    @property
    def free_pages(self):
        return int(self.occ.get("free_pages", 0))


class ServingRouter:
    """Fleet front door: ``submit`` requests, ``poll`` the control
    loop, ``results`` collect. Single-writer by design: one router owns
    assignment and re-queue (the store's CAS completions make even a
    misbehaving second writer safe, but the fleet runs one router)."""

    def __init__(self, store, substrate=None, hb_timeout=5.0, poll=0.05,
                 name="router", slo=None, affinity=None,
                 affinity_guard=None, backlog_limit=None):
        self._substrate = substrate if substrate is not None \
            else NATIVE_SUBSTRATE
        self._clock = self._substrate.clock
        self.store = store
        self.hb_timeout = float(hb_timeout)
        self.poll_interval = float(poll)
        self.name = name
        self.slo = slo             # observability.slo.SLOEngine | None
        # live exposition: PADDLE_METRICS_PORT set → this
        # process's /metrics endpoint (router counters ride the same
        # registry) is announced for `observability.top`; unset → None.
        # `close()` unannounces; a CRASHED router's entry heals when a
        # restarted router re-announces under the same name (announce
        # overwrites the address) — stated boundary: routers have no
        # heartbeat, so nothing can retire their endpoint for them
        from ...observability import expo
        self._expo = expo.start_if_configured()
        if self._expo is not None:
            expo.announce(store, self.name, self._expo.address)
        # prefix-affinity routing: on by default, scored
        # FIRST (deepest matched chain wins), most-free-pages as the
        # tiebreak. The guard keeps a hot prefix from piling onto a
        # full replica: a target whose discounted free pages fall below
        # it competes on capacity alone, affinity ignored.
        import os as _os
        _env = _os.environ.get
        if affinity is None:
            affinity = str(_env("PADDLE_SERVE_AFFINITY", "1")).lower() \
                not in ("0", "false", "off")
        self.affinity = bool(affinity)
        self.affinity_guard = float(
            affinity_guard if affinity_guard is not None
            else _env("PADDLE_SERVE_AFFINITY_GUARD", 8))
        self._chain_memo = {}      # (rid, page_size) -> chunk keys
        self._info_cache = {}      # i -> (gen, info): a replica's info
        # key is IMMUTABLE per (rank, serving-generation) — re-written
        # only when the replica re-registers into a new generation — so
        # re-reading it every poll tick was N wasted store round-trips
        # per tick.
        # Entries are only cached when the info's own generation matches
        # the current fleet generation, so a bump invalidates naturally.
        self._gen = None           # fleet generation at last discover()
        self.pending = []          # rids awaiting (re-)routing, FIFO
        self.assigned = {}         # rid -> replica i (latest route)
        self.requeues = {}         # rid -> times re-routed
        self.results = {}          # rid -> completion payload
        self._deadline_at = {}     # rid -> router-clock expiry
        self._dead = set()         # replicas declared dead
        self._draining = set()     # replicas this router is draining
        self._departed = set()     # drained/dead, tail already re-queued
        # admission control: bound on the router's own
        # pending backlog (0 = unbounded, the contract).
        # Past it — or when the measured drain rate says a deadline
        # can't be met through the current backlog — submit completes
        # the request IMMEDIATELY with the typed ``overloaded`` status
        # and a retry-after hint, exactly-once via the done CAS.
        self.backlog_limit = int(
            backlog_limit if backlog_limit is not None
            else _env("PADDLE_SERVE_ROUTER_BACKLOG", 0))
        self.overloaded_total = 0
        self._fleet_backlog = 0    # Σ replica waiting at last dispatch
        self._drain_rate = None    # completions/s EWMA (deadline est.)
        self._rate_mark = None     # (clock, harvested count) anchor
        self._harvested = 0

    # -- submission ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_token_id=None,
               deadline_s=None, temperature=0.0, top_k=0, top_p=1.0,
               seed=0, priority=0):
        """Register a request and try to route it. Returns the rid.
        Under admission control (``backlog_limit`` set) an unserviceable
        request — backlog at the bound, or a deadline the measured
        drain rate says the backlog already burns — completes
        IMMEDIATELY with the typed ``overloaded`` status instead of
        queueing toward certain timeout; callers read the completion's
        ``retry_after_s`` hint and re-submit."""
        store = self.store
        rid = str(store.add(fleet.k_rid(), 1) - 1)
        refusal = self._admission_refusal(deadline_s)
        if refusal is not None:
            reason, retry_after = refusal
            trace.event("serve.submit", rid=rid,
                        origin_unix_us=time.time() * 1e6)
            self._complete_overloaded(rid, reason, retry_after)
            return rid
        # wall-clock STAMP (metric only, never a deadline): same-host
        # replicas map it back to their own clock so TTFT counts queue
        # time, detection and re-routing — what p99-under-failover is
        # about
        payload = {"prompt": [int(t) for t in prompt],
                   "max_new_tokens": int(max_new_tokens),
                   "t_submit_unix": time.time()}
        if eos_token_id is not None:
            payload["eos_token_id"] = int(eos_token_id)
        # sampling knobs ride the payload so a failover RE-ROUTE resamples
        # the exact same trajectory on the new replica (positional PRNG
        # keys — serving/sampling.py); defaults are omitted to keep old
        # payloads and greedy requests byte-identical
        if temperature > 0:
            payload["temperature"] = float(temperature)
            payload["top_k"] = int(top_k)
            payload["top_p"] = float(top_p)
            payload["seed"] = int(seed)
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
            self._deadline_at[rid] = self._clock.monotonic() \
                + float(deadline_s)
        # priority class: omitted at the default so old
        # payloads and default traffic stay byte-identical
        if priority:
            payload["priority"] = int(priority)
        store.set(fleet.k_req(rid), json.dumps(payload))
        # the request's trace identity is born HERE: every later hop
        # (route, admit, prefill, decode tick, re-route, commit) carries
        # this rid, and request_timeline keys on the submit stamp
        trace.event("serve.submit", rid=rid,
                    origin_unix_us=payload["t_submit_unix"] * 1e6)
        self.pending.append(rid)
        self.dispatch()
        return rid

    # -- discovery / health --------------------------------------------------
    def discover(self):
        """Snapshot every registered replica's (state, info, occ)."""
        n = self.store.add(fleet.k_nrep(), 0)
        gen = self._gen = fleet.current_generation(self.store)
        views = []
        for i in range(n):
            state = fleet.read_state(self.store, i)
            if state is None:
                continue           # attach in flight: not routable yet
            info = occ = None
            try:
                cached = self._info_cache.get(i)
                if cached is not None and cached[0] == gen:
                    info = cached[1]
                else:
                    info = json.loads(
                        self.store.get(fleet.k_info(i)).decode())
                    if info.get("generation") == gen:
                        self._info_cache[i] = (gen, info)
                occ = fleet.read_occ(self.store, i)
            except KeyError:
                pass
            views.append(ReplicaView(i, state, info, occ))
        return views

    def _stale(self):
        """Replica ids whose heartbeat went stale (liveness verdict)."""
        base = fleet.REPLICA_RANK_BASE
        return {r - base for r in self.store.dead_ranks(self.hb_timeout)
                if r >= base}

    # -- routing -------------------------------------------------------------
    def _targets(self, views):
        # the generation captured with the views snapshot: re-reading it
        # here both cost an extra op per dispatch and raced the snapshot
        # (a bump between discover() and here judged old views against
        # the new generation)
        gen = self._gen if self._gen is not None \
            else fleet.current_generation(self.store)
        return [v for v in views
                if v.state == fleet.STATE_SERVING
                and v.i not in self._dead and v.i not in self._draining
                and v.i not in self._departed
                and v.info.get("generation") == gen]

    def dispatch(self, views=None):
        """Route as much of the pending queue as targets allow (FIFO;
        affinity-first — the replica already holding the request's
        prefix pages, deepest match wins, capacity-guarded — then
        most-free-pages, discounted by what this dispatch round
        already assigned)."""
        if not self.pending:
            return
        views = self.discover() if views is None else views
        targets = self._targets(views)
        FLEET_SIZE.set(len(targets))
        self._fleet_backlog = sum(int(v.occ.get("waiting", 0))
                                  for v in targets)
        if not targets:
            self._expire_pending()
            return
        load = {v.i: 0 for v in targets}
        for rid in self.pending:
            if rid in self.results:
                continue
            if self._overdue(rid):
                self._complete_timeout(rid)
                continue
            aff = self._affinity_pages(rid, targets) if self.affinity \
                else {}

            def score(v):
                eff = v.free_pages - load[v.i]
                # the occupancy guard: affinity only counts while the
                # target has real headroom — a hot prefix must not
                # pile its fan-in onto a full replica
                a = aff.get(v.i, 0) if eff >= self.affinity_guard else 0
                return (a, eff)

            best = max(targets, key=score)
            matched = aff.get(best.i, 0) \
                if (best.free_pages - load[best.i]) \
                >= self.affinity_guard else 0
            if matched:
                with trace.span("serve.affinity_route", rid=rid,
                                replica=best.i, pages=matched):
                    self._route(rid, best.i)
                AFFINITY_ROUTED.inc()
            else:
                self._route(rid, best.i)
            load[best.i] += 1
        # every pending rid was routed, completed or expired — there is
        # deliberately no router-side back-pressure: queueing happens
        # in the replica mailboxes, bounded by the deadline sweep
        self.pending = []

    def _chain_for(self, rid, page_size):
        """The request prompt's hash-chain keys at ``page_size`` —
        computed with the prefix cache's OWN ``_chunk_keys`` (bit-equal
        by construction), memoized per (rid, page_size)."""
        per_rid = self._chain_memo.setdefault(rid, {})
        got = per_rid.get(page_size)
        if got is None:
            try:
                payload = json.loads(
                    self.store.get(fleet.k_req(rid)).decode())
                prompt = payload.get("prompt") or []
            except (KeyError, ValueError):
                prompt = []
            got = per_rid[page_size] = _chunk_keys(prompt, page_size)
        return got

    def _affinity_pages(self, rid, targets):
        """{replica i: matched chain depth in pages} for every target
        advertising an affinity digest that intersects this request's
        prompt chain. Deeper match = more prefill skipped on that
        replica. Advisory only: the replica's prefill-time re-lookup
        stays the exact authority."""
        out = {}
        for v in targets:
            heads = v.occ.get("affinity")
            ps = int(v.occ.get("page_size") or 0)
            if not heads or ps <= 0:
                continue
            keys = self._chain_for(rid, ps)
            if not keys:
                continue
            head_set = set(heads)
            depth = 0
            for n, k in enumerate(keys):
                if k in head_set:
                    depth = n + 1
            if depth:
                out[v.i] = depth
        return out

    def _route(self, rid, i):
        # the payload already carries (deadline_s, t_submit_unix): the
        # replica's engine counts the deadline from the TRUE submit
        # stamp, so a re-routed request keeps its original budget — no
        # rewrite needed, and no immortality either way (the router's
        # own _deadline_at sweep covers unroutable/lost requests)
        requeue = self.requeues.get(rid, 0)
        with trace.span("serve.route", rid=rid, replica=i,
                        requeue=requeue):
            n = self.store.add(fleet.k_qn(i), 1)
            self.store.set(fleet.k_q(i, n - 1), rid)
        self.assigned[rid] = i
        ROUTED.inc()
        if requeue:
            REQUEUED.inc()

    def _requeue(self, rid):
        """Back to the head of the pending queue (it keeps its age and
        its deadline — a re-routed request can't be immortal)."""
        if rid in self.results:
            return
        done = fleet.read_done(self.store, rid)
        if done is not None:
            self.results[rid] = done      # completed before we re-route
            return
        self.requeues[rid] = self.requeues.get(rid, 0) + 1
        self.assigned.pop(rid, None)
        if rid not in self.pending:
            self.pending.insert(0, rid)

    # -- admission control ----------------------------------------
    def _est_wait(self):
        """Estimated seconds for the current backlog (router pending +
        replica waiting queues at the last dispatch) to drain, from the
        harvest-measured completion-rate EWMA. None until the rate has
        been observed — admission never guesses."""
        if not self._drain_rate or self._drain_rate <= 0:
            return None
        return (len(self.pending) + self._fleet_backlog) \
            / self._drain_rate

    def _admission_refusal(self, deadline_s):
        """(reason, retry_after_s) when the request must be refused;
        None admits. Only active once ``backlog_limit`` is set — the
        default keeps the admit-everything contract."""
        if not self.backlog_limit:
            return None
        est = self._est_wait()
        if len(self.pending) >= self.backlog_limit:
            hint = est if est is not None \
                else len(self.pending) * self.poll_interval
            return "backlog_limit", round(min(5.0, max(0.05, hint)), 3)
        if deadline_s is not None and est is not None \
                and est > float(deadline_s):
            return "deadline_unmeetable", \
                round(min(5.0, max(0.05, est - float(deadline_s))), 3)
        return None

    def _complete_overloaded(self, rid, reason, retry_after_s):
        trace.event("serve.shed", rid=rid, where="router", reason=reason)
        fleet.post_done(self.store, rid,
                        {"status": fleet.ST_OVERLOADED,
                         "router": self.name, "reason": reason,
                         "retry_after_s": retry_after_s})
        self.results[rid] = fleet.read_done(self.store, rid)
        self._deadline_at.pop(rid, None)
        self.overloaded_total += 1
        OVERLOADED.inc()
        if self.slo is not None:
            self.slo.record_request(rid=rid,
                                    status=fleet.ST_OVERLOADED)

    # -- deadlines -----------------------------------------------------------
    def _overdue(self, rid):
        at = self._deadline_at.get(rid)
        return at is not None and self._clock.monotonic() > at

    def _complete_timeout(self, rid):
        fleet.post_done(self.store, rid, {"status": fleet.ST_TIMEOUT,
                                          "router": self.name})
        self.results[rid] = fleet.read_done(self.store, rid)
        self.assigned.pop(rid, None)
        self._chain_memo.pop(rid, None)
        TIMEOUTS.inc()
        if self.slo is not None:
            self.slo.record_request(rid=rid, status=fleet.ST_TIMEOUT)

    def _expire_pending(self):
        still = []
        for rid in self.pending:
            if self._overdue(rid):
                self._complete_timeout(rid)
            else:
                still.append(rid)
        self.pending = still

    # -- departures ----------------------------------------------------------
    def _requeue_tail(self, i, from_n):
        """Re-route mailbox entries the departing replica never
        admitted (>= its pull cursor)."""
        qn = self.store.add(fleet.k_qn(i), 0)
        for n in range(int(from_n), qn):
            key = fleet.k_q(i, n)
            if self.store.check(key):
                self._requeue(self.store.get(key).decode())

    def _requeue_assigned(self, i):
        """Re-route everything assigned to ``i`` without a committed
        completion (the failure path: admitted-but-unfinished work is
        recomputed exactly on a survivor)."""
        for rid, owner in list(self.assigned.items()):
            if owner == i:
                self._requeue(rid)

    def _retire_endpoint(self, i):
        """Drop a dead replica's announced /metrics endpoint from the
        discovery index — a SIGKILLed replica cannot unannounce itself,
        and a dead address would otherwise cost every `top` refresh a
        connect timeout forever (the gauge-staleness class, applied to
        endpoints). CAS-guarded on the CORPSE's address: a restarted
        same-name replica that already re-announced is never blanked."""
        try:
            info = json.loads(self.store.get(fleet.k_info(i)).decode())
        except (KeyError, ValueError):
            return
        if info.get("metrics_addr") and info.get("name"):
            from ...observability import expo
            expo.retire_if_current(self.store, info["name"],
                                   info["metrics_addr"])

    def handle_death(self, i):
        """Heartbeat-staleness verdict on replica ``i``."""
        if i in self._departed:
            return
        trace.event("serve.replica_death", replica=i)
        self._dead.add(i)
        self._departed.add(i)
        with trace.span("serve.drain", replica=i, reason="death"):
            # fence the corpse's state key so it is never picked again
            # (and a zombie that wakes up sees it and drains itself)
            for frm in (fleet.STATE_SERVING, fleet.STATE_DRAINING):
                _, won = self.store.compare_set(
                    fleet.k_state(i), frm, fleet.STATE_DEAD)
                if won:
                    break
            self._requeue_assigned(i)
            self._retire_endpoint(i)
            gen = fleet.current_generation(self.store)
            fleet.bump_generation(self.store, gen)
        self.dispatch()

    def drain(self, i, reason="scale-in", timeout=60.0):
        """Graceful departure: stop admissions, let in-flight finish,
        re-route the never-admitted tail, fence via a generation bump.
        Returns True when the replica drained cleanly (False: it died
        mid-drain and the failure path re-queued everything)."""
        clean = True
        with trace.span("serve.drain", replica=i, reason=reason):
            _, won = self.store.compare_set(
                fleet.k_state(i), fleet.STATE_SERVING,
                fleet.STATE_DRAINING)
            if not won and fleet.read_state(self.store, i) not in (
                    fleet.STATE_DRAINING, fleet.STATE_STOPPED):
                return False       # already dead/unknown: death path
            self._draining.add(i)
            deadline = self._clock.monotonic() + float(timeout)
            while not self.store.check(fleet.k_drained(i)):
                if i in self._stale():
                    clean = False
                    break
                if self._clock.monotonic() >= deadline:
                    clean = False
                    break
                self._clock.sleep(self.poll_interval)
            if clean:
                cursor = int(self.store.get(fleet.k_drained(i)))
                self._harvest()    # collect what it finished in-flight
                self._requeue_tail(i, cursor)
            else:
                self._dead.add(i)
                self._requeue_assigned(i)
                self._retire_endpoint(i)   # died mid-drain: it cannot
                # unannounce itself anymore
            self._departed.add(i)
            gen = fleet.current_generation(self.store)
            fleet.bump_generation(self.store, gen)
        self.dispatch()
        return clean

    # -- control loop --------------------------------------------------------
    def _harvest(self):
        harvested = 0
        for rid in list(self.assigned):
            if rid in self.results:
                self.assigned.pop(rid, None)
                continue
            done = fleet.read_done(self.store, rid)
            if done is not None:
                self.results[rid] = done
                self.assigned.pop(rid, None)
                self._chain_memo.pop(rid, None)
                harvested += 1
                # commit boundary + the REVERSE anchor sample (a
                # replica-domain wall stamp observed on this clock)
                ev = {"rid": rid, "replica": done.get("replica"),
                      "status": done.get("status")}
                if done.get("t_done_unix") is not None:
                    ev["done_unix_us"] = done["t_done_unix"] * 1e6
                trace.event("req.done", **ev)
                if self.slo is not None:
                    self.slo.record_request(
                        rid=rid, ttft_ms=done.get("ttft_ms"),
                        status=done.get("status"),
                        replica=done.get("replica"))
                if self.requeues.get(rid):
                    # the failover-recovery boundary the availability
                    # benchmark reads off the trace
                    trace.event("serve.requeued_done", rid=rid,
                                replica=done.get("replica"))
        # completion-rate EWMA (feeds the deadline-aware admission
        # estimate): rate is measured between harvests that actually
        # collected something, so idle polls don't decay it to zero
        if harvested:
            now = self._clock.monotonic()
            if self._rate_mark is not None and now > self._rate_mark:
                inst = harvested / (now - self._rate_mark)
                self._drain_rate = inst if self._drain_rate is None \
                    else 0.7 * self._drain_rate + 0.3 * inst
            self._rate_mark = now

    def poll(self):
        """One control iteration: harvest completions, judge liveness,
        finish drains, expire deadlines, dispatch."""
        self._harvest()
        if self.slo is not None:
            self.slo.tick(self.store)
        views = self.discover()
        for i in sorted(self._stale() - self._dead - self._departed):
            self.handle_death(i)
        for v in views:
            # a replica that drained on ITS OWN initiative (SIGTERM,
            # local stop, model roll) posts the same pull cursor a
            # router-driven drain does — its never-admitted mailbox
            # tail is ours to re-route. Departed FIRST so no further
            # dispatch can race a route into the abandoned mailbox
            # (its admitted in-flight all committed before the cursor
            # was posted, so the tail is the whole exposure).
            if v.i in self._departed or v.i in self._dead:
                continue
            if self.store.check(fleet.k_drained(v.i)):
                self._departed.add(v.i)
                with trace.span("serve.drain", replica=v.i,
                                reason="self-drain"):
                    self._requeue_tail(
                        v.i, int(self.store.get(fleet.k_drained(v.i))))
                    gen = fleet.current_generation(self.store)
                    fleet.bump_generation(self.store, gen)
        self._expire_pending()
        self.dispatch(views)

    def close(self):
        """Retire this router's announced /metrics endpoint (the
        server itself is the process-global singleton and stays up).
        Call at orderly shutdown; a crashed router's entry is healed
        by the next same-name announce."""
        if self._expo is not None:
            from ...observability import expo
            expo.unannounce(self.store, self.name)
            self._expo = None

    def await_results(self, rids, timeout=120.0):
        """Drive ``poll`` until every rid has a completion (or the
        budget runs out). Returns {rid: completion}."""
        deadline = self._clock.monotonic() + float(timeout)
        rids = [str(r) for r in rids]
        while self._clock.monotonic() < deadline:
            self.poll()
            if all(r in self.results for r in rids):
                return {r: self.results[r] for r in rids}
            self._clock.sleep(self.poll_interval)
        missing = [r for r in rids if r not in self.results]
        raise TimeoutError(
            f"{len(missing)} request(s) unresolved within {timeout}s: "
            f"{missing[:8]} (assigned={ {r: self.assigned.get(r) for r in missing[:8]} })")
