"""Synthetic open-loop load driver + the static-batching baseline (counterpart:
``paddle_tpu/inference/serving/load.py``).

OPEN LOOP means arrivals are a function of time only — a Poisson
process at ``rate`` req/s whose clock never waits for the server (the
fleet traffic model: users do not pace themselves to your decode
throughput). The driver replays a seeded arrival schedule against a
real engine: each loop iteration feeds every request whose arrival time
has passed into the scheduler's waiting queue, then runs one engine
step. TTFT is measured from the ARRIVAL stamp, so queueing delay counts
— exactly what p99 under load is about.

The STATIC baseline runs the SAME request schedule on the same engine
machinery with ``Scheduler.static_batching`` on: a batch is admitted
only when the previous batch fully drained. The continuous-vs-static
tokens/sec ratio isolates the
scheduling policy — kernels, cache and model are shared.
"""
from __future__ import annotations

import time

from ...observability.metrics import percentile as _pct
from . import fleet
from .engine import ServingEngine
from .scheduler import Request


def synth_requests(n, vocab_size, *, rate=50.0, prompt_lens=(16, 48),
                   max_new=(4, 32), max_new_dist="loguniform",
                   shared_prefix_len=0, shared_frac=0.0, seed=0,
                   deadline_s=None):
    """A seeded open-loop request schedule. ``shared_frac`` of the
    requests start with one common ``shared_prefix_len``-token system
    prefix (the prefix-cache traffic shape); arrival gaps are
    exponential at ``rate`` req/s. Generation lengths default to
    LOG-UNIFORM over ``max_new`` — production output lengths are
    heavy-tailed (short answers dominate, long generations set the
    batch drain time), which is precisely the shape static batching
    pays for; pass ``max_new_dist="uniform"`` for the flat variant."""
    import math

    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab_size, shared_prefix_len).tolist() \
        if shared_prefix_len else []
    t = 0.0
    reqs = []
    lo, hi = max_new
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        body = rng.integers(1, vocab_size, plen).tolist()
        prompt = prefix + body if (prefix and rng.random() < shared_frac) \
            else body
        if max_new_dist == "loguniform":
            mn = int(round(math.exp(rng.uniform(math.log(lo),
                                                math.log(hi)))))
        else:
            mn = int(rng.integers(lo, hi + 1))
        item = {
            "arrival_offset_s": t,
            "prompt": prompt,
            "max_new_tokens": max(mn, 1),
        }
        if deadline_s is not None:
            item["deadline_s"] = float(deadline_s)
        reqs.append(item)
    return reqs


def run_open_loop(model, schedule, config=None, static=False,
                  time_scale=1.0, device=None):
    """Replay ``schedule`` (from ``synth_requests``) open-loop against a
    fresh engine. ``time_scale`` compresses the arrival clock (0 = all
    requests arrive immediately — the backlogged regime benchmarks
    use). The arrival clock starts after the engine's construction, so
    TTFT excludes its graph capture. ``device`` follows the port's rule.
    Returns (results, stats)."""
    eng = ServingEngine(model, config, device=device)
    if static:
        eng.scheduler.static_batching = True
    t0 = time.perf_counter()
    pending = []
    for item in schedule:
        pending.append((item["arrival_offset_s"] * time_scale, item))
    pending.sort(key=lambda x: x[0])
    submitted = []
    i = 0
    while i < len(pending) or eng.has_work():
        now = time.perf_counter() - t0
        while i < len(pending) and pending[i][0] <= now:
            off, item = pending[i]
            req = Request(item["prompt"],
                          max_new_tokens=item["max_new_tokens"],
                          arrival_t=t0 + off,
                          deadline_s=item.get("deadline_s"))
            eng.submit(req)
            submitted.append(req)
            i += 1
        if eng.has_work():
            eng.step()
        elif i < len(pending):
            # idle until the next arrival (open loop: we cannot pull it
            # forward) — sleep the remaining gap, capped for safety
            time.sleep(min(max(pending[i][0] - now, 0.0), 0.05))
    wall = time.perf_counter() - t0
    return submitted, summarize(submitted, wall, eng)


class ClosedLoopClient:
    """Closed-loop fleet client with typed-refusal retries.
    ``concurrency`` sessions drain a shared work list through a
    ``ServingRouter``; a session whose request comes
    back with the typed ``overloaded`` status backs off — capped
    exponential with full jitter, floored at the completion's
    ``retry_after_s`` hint — then re-submits the SAME item as a fresh
    rid (each rid's completion is exactly-once via the done CAS; the
    retry chain is the client's, and every attempt lands in the
    ``attempts`` ledger). The jitter stream comes from the substrate
    ``rng`` plane, so a run under ``PADDLE_BACKOFF_SEED``
    replays its backoff schedule bit-for-bit.

    A session in backoff still occupies its concurrency slot — that is
    what makes the loop CLOSED: refused work self-paces instead of
    re-stampeding the fleet (the congestion-collapse shape the
    ``serving_overload`` row prices)."""

    def __init__(self, router, concurrency=4, max_retries=6,
                 base_backoff_s=0.05, max_backoff_s=2.0,
                 substrate=None, name="client"):
        self.router = router
        self._substrate = substrate if substrate is not None \
            else router._substrate
        self._clock = self._substrate.clock
        self._rng = self._substrate.rng(f"closed-loop:{name}")
        self.concurrency = int(concurrency)
        self.max_retries = int(max_retries)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.retries = 0           # re-submissions actuated
        self.refusals = 0          # overloaded completions observed

    def _backoff(self, attempt, hint=None):
        base = min(self.max_backoff_s,
                   self.base_backoff_s * (2 ** attempt))
        if hint:
            base = max(base, float(hint))
        # full jitter over [base/2, base]: decorrelates the retry wave
        # the same way the store-failover reprobe backoff does
        return base * (0.5 + 0.5 * self._rng.random())

    def _submit(self, idx, item, attempt, inflight):
        rid = self.router.submit(
            item["prompt"],
            max_new_tokens=item.get("max_new_tokens", 16),
            eos_token_id=item.get("eos_token_id"),
            deadline_s=item.get("deadline_s"),
            priority=item.get("priority", 0))
        inflight[rid] = (idx, item, attempt)
        return rid

    def run(self, items, timeout=120.0):
        """Drive every item to a typed terminal outcome (or exhaust
        ``timeout``). Returns {item index: outcome} where outcome is
        the final completion payload plus ``rid`` and ``attempts``."""
        work = list(enumerate(items))
        work.reverse()             # pop() below = FIFO over items
        outcomes = {}
        inflight = {}              # rid -> (idx, item, attempt)
        backoffs = []              # (wake_at, idx, item, attempt)
        deadline = self._clock.monotonic() + float(timeout)
        while len(outcomes) < len(items):
            if self._clock.monotonic() >= deadline:
                break
            now = self._clock.monotonic()
            matured = [b for b in backoffs if b[0] <= now]
            backoffs = [b for b in backoffs if b[0] > now]
            for _, idx, item, attempt in matured:
                self._submit(idx, item, attempt, inflight)
            while work and len(inflight) + len(backoffs) \
                    < self.concurrency:
                idx, item = work.pop()
                self._submit(idx, item, 0, inflight)
            self.router.poll()
            progressed = bool(matured)
            for rid in [r for r in inflight
                        if r in self.router.results]:
                idx, item, attempt = inflight.pop(rid)
                res = self.router.results[rid]
                status = res.get("status")
                if status == fleet.ST_OVERLOADED:
                    self.refusals += 1
                    if attempt < self.max_retries:
                        self.retries += 1
                        wake = now + self._backoff(
                            attempt, res.get("retry_after_s"))
                        backoffs.append((wake, idx, item, attempt + 1))
                        progressed = True
                        continue
                outcomes[idx] = dict(res, rid=rid,
                                     attempts=attempt + 1)
                progressed = True
            if not progressed:
                self._clock.sleep(self.router.poll_interval)
        return outcomes


def summarize(requests, wall_s, engine=None):
    done = [r for r in requests if r.state == "finished"]
    timed_out = [r for r in requests if r.state == "timeout"]
    out_tokens = sum(len(r.output_tokens) for r in done)
    ttfts = [r.ttft_s * 1e3 for r in done if r.ttft_s is not None]
    tpots = [r.tpot_s * 1e3 for r in done if r.tpot_s is not None]
    stats = {
        "requests": len(requests),
        "finished": len(done),
        "timeouts": len(timed_out),
        "wall_s": round(wall_s, 4),
        "output_tokens": out_tokens,
        "tokens_per_sec": round(out_tokens / wall_s, 2) if wall_s else None,
        "ttft_p50_ms": round(_pct(ttfts, 0.50), 2) if ttfts else None,
        "ttft_p99_ms": round(_pct(ttfts, 0.99), 2) if ttfts else None,
        "tpot_p50_ms": round(_pct(tpots, 0.50), 2) if tpots else None,
    }
    if engine is not None:
        # each request's FIRST token comes from its prefill; only the
        # rest occupied decode slots
        decode_tokens = max(out_tokens - len(done), 0)
        occ = decode_tokens / max(
            engine.decode_steps * engine.config.max_batch, 1)
        stats.update({
            "decode_steps": engine.decode_steps,
            "batch_occupancy_mean": round(occ, 3),
            "evictions": engine.scheduler.evicted_total,
            "prefix_lookups": engine.prefix_cache.lookups,
            "prefix_hits": engine.prefix_cache.hits,
        })
        if engine.spec_verify_steps:
            # speculative decoding: committed/step counts the
            # bonus token, so > 1 means verify beats one-per-dispatch
            vs = engine.spec_verify_steps
            stats.update({
                "spec_verify_steps": vs,
                "spec_accepted_tokens": engine.spec_accepted_total,
                "spec_accepted_per_step":
                    round(engine.spec_accepted_total / vs, 3),
                "spec_committed_per_step":
                    round(engine.spec_committed_total / vs, 3),
            })
    return stats
