"""Continuous-batching scheduler: request lifecycle + per-step batch
composition (counterpart: ``paddle_tpu/inference/serving/scheduler.py``;
reference analogs: Orca-style iteration-level scheduling and vLLM's
scheduler).

Policy, per engine step:

- ADMIT (prefill side): FCFS over the waiting queue, bounded by three
  budgets at once — free decode slots, free KV pages for the prompt
  (+1 lookahead page so the first appends cannot immediately evict),
  and the per-step PREFILL TOKEN BUDGET (long prompts must not starve
  running decodes: admission stops once the step has prefilled its
  token budget, the rest of the queue waits a step). Prefix-cache hits
  consume budget only for their un-cached tail.
- DECODE: every running slot advances one token per step; sequences
  finish on max_new_tokens or eos and their slot frees the same step
  (the next step's admit refills it) — no head-of-line waiting on
  batch-mates, which is exactly the static-batching failure mode.
- EVICT (allocation pressure): when a running sequence needs its next
  page and the pool is dry even after prefix-cache reclaim, the
  YOUNGEST running sequence is evicted back to the waiting queue
  (its pages freed, its generated tokens discarded — it will re-prefill
  later); youngest-first wastes the least completed work and can never
  starve the oldest request.

The scheduler is plain Python: it owns Request/Sequence bookkeeping and
the block tables, while the engine owns the tensors and the step
functions.
"""
from __future__ import annotations

import itertools
import time
from collections import deque

from ...observability import trace
from .kv_cache import BlockTable, CacheFull

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"
TIMEOUT = "timeout"
# shed by admission control / load shedding before any token was
# committed: the typed refusal clients may retry (fleet.ST_OVERLOADED)
OVERLOADED = "overloaded"

_ids = itertools.count()


class RequestTooLarge(ValueError):
    """The request's prompt + max_new_tokens can NEVER fit the engine's
    KV page pool: admitting it would enter the evict/re-prefill cycle
    forever (it evicts everything, still cannot finish, gets evicted in
    turn). Typed so callers — the router's admission path in
    particular — can complete the request with a structured error
    instead of crashing or spinning. The message names the page
    budget."""


class RequestTimeout(RuntimeError):
    """A request sat in a queue past its deadline. Raised only by
    callers that want an exception; the scheduler itself completes the
    request with the typed ``TIMEOUT`` state instead."""


class EngineOverloaded(RuntimeError):
    """The engine's waiting queue is at its admission limit
    (``PADDLE_SERVE_QUEUE_LIMIT``): accepting another request would
    only deepen a backlog the deadline sweep will later burn through.
    Typed so the replica/router can complete the request with the
    structured ``overloaded`` status (plus a retry-after hint) instead
    of queueing it to certain death."""


class Request:
    """One generation request as the user submits it.

    ``deadline_s`` (optional) is a QUEUE deadline relative to
    ``arrival_t``: a request still waiting for admission past it
    completes with the typed ``TIMEOUT`` state instead of waiting
    unboundedly. Eviction sends a request back to the waiting queue
    with its ORIGINAL arrival stamp, so the deadline keeps counting —
    a re-queued (or router-re-routed) request can't be silently
    immortal."""

    def __init__(self, prompt_tokens, max_new_tokens=16, eos_token_id=None,
                 request_id=None, arrival_t=None, deadline_s=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=0,
                 priority=0):
        self.id = request_id if request_id is not None else next(_ids)
        # the TRACE identity: defaults to the engine-local id;
        # the fleet harness overwrites it with the router's rid so every
        # serve.* span/event names one stable id across processes —
        # including across a failover re-route
        self.rid = str(self.id)
        self.prompt_tokens = [int(t) for t in prompt_tokens]
        if not self.prompt_tokens:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        # sampling knobs: temperature <= 0 is GREEDY (the default —
        # the same tokens as model.generate); otherwise a seeded draw
        # keyed by (seed, position) (serving/sampling.py), reproducible
        # across dispatches, batch compositions and speculative vs plain
        # decoding
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        # priority class: higher = more important. Admission
        # inserts ahead of strictly-lower classes (FIFO within a class)
        # and load shedding picks victims lowest-class-first, so under
        # overload the batch fills with the traffic the operator ranked.
        self.priority = int(priority)
        self.arrival_t = arrival_t if arrival_t is not None \
            else time.perf_counter()
        # filled in by the engine
        self.output_tokens = []
        self.state = WAITING
        self.t_first_token = None          # perf_counter at first token
        self.t_finished = None
        self.prefix_hit_tokens = 0         # prompt tokens skipped by cache
        self.evictions = 0

    def expired(self, now=None):
        if self.deadline_s is None:
            return False
        now = time.perf_counter() if now is None else now
        return now - self.arrival_t > self.deadline_s

    @property
    def ttft_s(self):
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_t

    @property
    def tpot_s(self):
        """Mean time per output token AFTER the first."""
        if self.t_finished is None or len(self.output_tokens) < 2:
            return None
        return (self.t_finished - self.t_first_token) \
            / (len(self.output_tokens) - 1)


class Sequence:
    """A running request bound to a decode slot and a block table."""

    def __init__(self, request, table, slot, admitted_seq):
        self.request = request
        self.table = table                 # BlockTable
        self.slot = slot                   # decode batch index
        self.admitted_seq = admitted_seq   # admission order (evict pick)
        self.last_token = None             # next decode input

    @property
    def context_len(self):
        return self.table.length


class Scheduler:
    """Slot + queue bookkeeping. The engine drives it:

    ``plan_admissions()`` -> [(request, adopted_keys, adopted_pages)]
    then per admitted request the engine prefills and calls ``bind``;
    ``running`` lists live sequences; ``finish``/``evict`` retire them.
    """

    def __init__(self, cache, prefix_cache, max_batch, prefill_token_budget,
                 static_batching=False, queue_limit=0):
        self.cache = cache
        self.prefix_cache = prefix_cache
        self.max_batch = int(max_batch)
        self.prefill_token_budget = int(prefill_token_budget)
        # static_batching reproduces the naive baseline ON THE SAME
        # machinery (same kernels, cache, engine): admit only into an
        # EMPTY batch, then run that batch to completion, so a
        # continuous-vs-static comparison isolates the policy.
        self.static_batching = bool(static_batching)
        # admission limit on the WAITING queue (0 = unbounded):
        # submit raises EngineOverloaded past
        # it. Evictions are exempt — an admitted request coming back
        # must never turn into a refusal.
        self.queue_limit = int(queue_limit)
        self.waiting = deque()
        self.slots = [None] * self.max_batch   # slot -> Sequence | None
        self._admit_counter = itertools.count()
        self.evicted_total = 0
        self.timeouts = 0
        self.shed_total = 0
        self.finished = []

    # -- queue side ----------------------------------------------------------
    def submit(self, request):
        if self.queue_limit and len(self.waiting) >= self.queue_limit:
            raise EngineOverloaded(
                f"waiting queue at limit ({self.queue_limit})")
        request.state = WAITING
        # priority classes: insert ahead of the first STRICTLY lower
        # class; FIFO within a class so same-class traffic stays FCFS
        # (plan_admissions' no-skip-ahead reads the queue order, which
        # is exactly this class-then-arrival order)
        if request.priority > 0:
            for i, r in enumerate(self.waiting):
                if r.priority < request.priority:
                    self.waiting.insert(i, request)
                    return
        self.waiting.append(request)

    @property
    def running(self):
        return [s for s in self.slots if s is not None]

    @property
    def occupancy(self):
        return len(self.running)

    def has_work(self):
        return bool(self.waiting or self.running)

    def _free_slot(self):
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _pages_needed(self, prompt_len, adopted_pages):
        ps = self.cache.page_size
        total = (prompt_len + ps - 1) // ps
        return max(total - adopted_pages, 0) + 1   # +1 decode lookahead

    def expire_overdue(self, now=None):
        """Sweep the waiting queue: any request (at the head OR blocked
        behind a bigger one) whose queue deadline has passed completes
        with the typed TIMEOUT state. Evicted requests re-enter the
        queue with their original arrival stamp, so the sweep also
        bounds the evict/re-prefill cycle for deadline-carrying
        requests."""
        if not any(r.deadline_s is not None for r in self.waiting):
            return
        now = time.perf_counter() if now is None else now
        keep = deque()
        for req in self.waiting:
            if req.expired(now):
                self.finish_timeout(req, now)
            else:
                keep.append(req)
        self.waiting = keep

    def finish_timeout(self, req, now=None):
        """Complete a queued request with the typed timeout status."""
        req.state = TIMEOUT
        req.t_finished = time.perf_counter() if now is None else now
        self.timeouts += 1
        self.finished.append(req)
        trace.event("req.finish", rid=req.rid, status=TIMEOUT)

    def finish_overloaded(self, req, reason="shed", now=None):
        """Complete a WAITING request with the typed overloaded status
        (admission refusal or shed victim). Never called on a running
        sequence — shedding is contractually refusal-before-work."""
        req.state = OVERLOADED
        req.t_finished = time.perf_counter() if now is None else now
        self.shed_total += 1
        self.finished.append(req)
        trace.event("req.finish", rid=req.rid, status=OVERLOADED,
                    reason=reason)

    def shed(self, n=1, reason="pressure"):
        """Load shedding: complete up to ``n`` WAITING requests with the
        typed overloaded status instead of letting the eviction storm
        re-prefill them forever. Victim order is the contract —
        lowest priority class first, then deepest deadline (most
        remaining slack; no deadline sorts as infinite slack), then
        youngest arrival — so the work the operator ranked, and the work
        closest to completing in time, survives. RUNNING sequences are
        never touched: an assigned request's tokens are already being
        computed and its completion rides the normal path. Returns the
        shed requests."""
        if n <= 0 or not self.waiting:
            return []
        now = time.perf_counter()

        def slack(r):
            if r.deadline_s is None:
                return float("inf")
            return r.arrival_t + r.deadline_s - now

        victims = sorted(self.waiting,
                         key=lambda r: (r.priority, -slack(r),
                                        -r.arrival_t))[:int(n)]
        chosen = set(map(id, victims))
        self.waiting = deque(r for r in self.waiting
                             if id(r) not in chosen)
        for req in victims:
            trace.event("serve.shed", rid=req.rid, reason=reason,
                        priority=req.priority)
            self.finish_overloaded(req, reason=reason, now=now)
        return victims

    def plan_admissions(self):
        """Pick the requests this step prefills, under the three
        budgets. Returns [(request, adopted_keys, adopted_pages)];
        the engine prefills each and calls ``bind``."""
        self.expire_overdue()
        if self.static_batching and self.running:
            return []
        plans = []
        budget = self.prefill_token_budget
        reserved_pages = 0   # pages earlier plans of THIS round will
        # consume at prefill: without the reservation one round could
        # admit two prompts against the same free pages and the second
        # prefill would die with an uncaught CacheFull
        while self.waiting and budget > 0:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.waiting[0]
            keys, pages = self.prefix_cache.lookup(req.prompt_tokens,
                                                   count=False)
            # a hit must leave >= 1 tail token: the tail prefill both
            # produces the first output logits and keeps shared pages
            # append-immutable (docs/SERVING.md, prefix-key semantics)
            ps = self.cache.page_size
            max_adopt = (len(req.prompt_tokens) - 1) // ps
            keys, pages = keys[:max_adopt], pages[:max_adopt]
            tail = len(req.prompt_tokens) - len(pages) * ps
            if plans and tail > budget:
                break          # keep at least one admission progressing
            needed = self._pages_needed(len(req.prompt_tokens), len(pages))
            if not self.cache.can_allocate(needed + reserved_pages):
                break          # FCFS: don't skip ahead of a big request
            reserved_pages += needed
            self.waiting.popleft()
            # reserve the slot now so one plan round never double-books
            seq = Sequence(req, BlockTable(self.cache), slot,
                           next(self._admit_counter))
            self.slots[slot] = seq
            req.state = RUNNING
            budget -= max(tail, 0)
            plans.append((seq, keys, pages))
        return plans

    def bind(self, seq, last_token):
        """Prefill done: arm the sequence for decoding."""
        seq.last_token = int(last_token)
        seq.request.output_tokens.append(int(last_token))
        if seq.request.t_first_token is None:
            seq.request.t_first_token = time.perf_counter()

    # -- decode side ---------------------------------------------------------
    def ensure_decode_capacity(self, n_for=None):
        """Every running sequence gets KV slots for the tokens the
        coming dispatch will scatter — 1 for plain decode, cap + 1 for
        a speculative verify (``n_for(seq)`` supplies the per-sequence
        count; rejected rows are rolled back by ``BlockTable.truncate``
        afterwards) — evicting the youngest sequences on allocation
        failure. Oldest sequences are served first so an eviction
        victim is always a not-yet-served younger one; the final filter
        drops any entry whose sequence got evicted after being served
        (belt and braces). The table length is COMMITTED here (base +
        n); the engine truncates back to the verified commit point.
        Returns [(seq, base_length, pages, offsets)] for the
        survivors."""
        out = []
        for seq in sorted(self.running, key=lambda s: s.admitted_seq):
            if self.slots[seq.slot] is not seq:
                continue   # evicted by an earlier iteration's pressure:
                # touching its RELEASED table would allocate a page into
                # a dropped object — a permanent pool leak
            n = 1 if n_for is None else max(1, int(n_for(seq)))
            base = seq.table.length
            pages, offs = [], []
            while len(pages) < n:
                try:
                    page, off = seq.table.slot_for_append()
                    seq.table.length += 1
                    pages.append(page)
                    offs.append(off)
                except CacheFull:
                    victim = self._evict_youngest(exclude=seq)
                    if victim is None:
                        # roll the partial reservation back before
                        # surfacing: the raise aborts the step and the
                        # half-reserved rows would otherwise leak into
                        # the table as never-written "context"
                        seq.table.truncate(base)
                        raise CacheFull(
                            "one sequence alone exceeds the KV pool")
            out.append((seq, base, pages, offs))
        return [e for e in out if self.slots[e[0].slot] is e[0]]

    def _evict_youngest(self, exclude=None):
        cands = [s for s in self.running if s is not exclude]
        if not cands:
            return None
        victim = max(cands, key=lambda s: s.admitted_seq)
        self.evict(victim)
        return victim

    def evict(self, seq):
        """Back to the waiting queue (front: it keeps its arrival
        order priority), pages freed, generated tokens discarded."""
        self.slots[seq.slot] = None
        seq.table.release(self.prefix_cache)
        req = seq.request
        req.output_tokens = []
        req.t_first_token = None
        req.state = WAITING
        req.evictions += 1
        self.evicted_total += 1
        self.waiting.appendleft(req)
        trace.event("req.evict", rid=req.rid,
                    evictions=req.evictions)

    def advance(self, seq, token):
        """Record one decoded token; finish when the budget or eos is
        hit. Returns True while the sequence keeps running."""
        req = seq.request
        req.output_tokens.append(int(token))
        seq.last_token = int(token)
        done = len(req.output_tokens) >= req.max_new_tokens or (
            req.eos_token_id is not None
            and int(token) == int(req.eos_token_id))
        if done:
            self.finish(seq)
        return not done

    def finish(self, seq):
        req = seq.request
        req.state = FINISHED
        req.t_finished = time.perf_counter()
        self.slots[seq.slot] = None
        # the engine already published the prompt's full pages at
        # prefill time; releasing decrefs the shared ones (LRU-resident
        # at zero) and frees the private ones
        seq.table.release(self.prefix_cache)
        self.finished.append(req)
        trace.event("req.finish", rid=req.rid, status=FINISHED,
                    tokens=len(req.output_tokens))
