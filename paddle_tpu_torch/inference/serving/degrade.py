"""Graceful degradation (brownout) for the serving plane (counterpart:
``paddle_tpu/inference/serving/degrade.py``).

The ``DegradationController`` is a DETERMINISTIC ladder driven by the
same published signals the autoscaler reads — engine backlog, free KV
pages, and the fleet SLO burn flag — so a replay of the same signal
sequence walks the same transitions. Beats are counted, not timed:
hysteresis is "N consecutive hot beats" / "M consecutive cool beats",
which makes the controller clock-free and checker-explorable.

The ladder (each step keeps the caps of the steps below it):

====  =========================  =====================================
step  cap applied                cost
====  =========================  =====================================
L0    none                       —
L1    spec_k -> spec_cap         lossless: verify only ever commits
                                 tokens the full model agreed to;
                                 fewer draft rows per dispatch
L2    prefill budget -> cap      lossless: chunked prefill composes
                                 the same KV; TTFT of big prompts
                                 stretches, decodes keep their cadence
L3    max_new_tokens -> cap      LOSSY for requests admitted while
                                 active: their generation budget is
                                 clamped (the response is a prefix of
                                 the uncapped one — never different
                                 tokens)
====  =========================  =====================================

Every transition runs inside a ``serve.degrade`` span and lands in the
``decisions`` ledger; caps release in reverse order on recovery, so
the whole ladder is reversible.

Load shedding rides the same controller beat: when the fleet burn flag
is up or free pages cross the watermark, the WAITING queue beyond one refill's worth is completed with the
typed ``overloaded`` status (``Scheduler.shed`` picks the
contractually lowest-priority / deepest-deadline victims) instead of
feeding the evict/re-prefill storm.

Env knobs (docs/SERVING.md): ``PADDLE_SERVE_DEGRADE`` gates the whole
controller (off by default — the replica only builds one when set);
``PADDLE_SERVE_DEGRADE_BACKLOG`` / ``_FREE_PAGES`` set the hot
watermarks (defaults derived from the engine's max_batch / pool size);
``_DWELL`` / ``_RECOVER`` the hysteresis beats; ``_SPEC_CAP`` /
``_PREFILL_CAP`` / ``_MAX_NEW`` the ladder caps; ``_SHED_KEEP`` how
much waiting queue shedding leaves behind.
"""
from __future__ import annotations

import os

from ...observability import metrics, trace

DEGRADE_LEVEL = metrics.gauge(
    "serving_degrade_level", "current brownout ladder step (0 = normal)")
DEGRADE_TRANSITIONS = metrics.counter(
    "serving_degrade_transitions_total", "ladder transitions (both ways)")
SHED_TOTAL = metrics.counter(
    "serving_shed_total", "waiting requests shed with typed overloaded")

MAX_LEVEL = 3


def _env_int(name, default):
    v = os.environ.get(name)
    return int(default if v in (None, "") else v)


class DegradeConfig:
    """Ladder thresholds and caps. Engine-derived defaults are filled
    by the controller at bind time (they need max_batch / pool size /
    prefill budget, which the env parser cannot know)."""

    def __init__(self, backlog_hi=None, backlog_lo=None,
                 free_pages_lo=None, free_pages_ok=None,
                 dwell_beats=None, recover_beats=None,
                 spec_cap=None, prefill_cap=None, max_new_cap=None,
                 shed_keep=None):
        e = _env_int
        self.backlog_hi = backlog_hi if backlog_hi is not None \
            else e("PADDLE_SERVE_DEGRADE_BACKLOG", 0) or None
        self.backlog_lo = backlog_lo
        self.free_pages_lo = free_pages_lo if free_pages_lo is not None \
            else e("PADDLE_SERVE_DEGRADE_FREE_PAGES", 0) or None
        self.free_pages_ok = free_pages_ok
        self.dwell_beats = dwell_beats if dwell_beats is not None \
            else e("PADDLE_SERVE_DEGRADE_DWELL", 2)
        self.recover_beats = recover_beats if recover_beats is not None \
            else e("PADDLE_SERVE_DEGRADE_RECOVER", 6)
        self.spec_cap = spec_cap if spec_cap is not None \
            else e("PADDLE_SERVE_DEGRADE_SPEC_CAP", 1)
        self.prefill_cap = prefill_cap if prefill_cap is not None \
            else e("PADDLE_SERVE_DEGRADE_PREFILL_CAP", 0) or None
        self.max_new_cap = max_new_cap if max_new_cap is not None \
            else e("PADDLE_SERVE_DEGRADE_MAX_NEW", 8)
        self.shed_keep = shed_keep if shed_keep is not None \
            else e("PADDLE_SERVE_SHED_KEEP", 0) or None


def enabled_from_env():
    return str(os.environ.get("PADDLE_SERVE_DEGRADE", "")).lower() \
        in ("1", "true", "on", "yes")


class DegradationController:
    """One per engine. Drive it with ``tick(burning=...)`` on the serve
    loop beat; it reads the engine's own backlog/free-pages signals,
    walks the ladder with beat-counted hysteresis, applies/releases the
    caps through ``engine.apply_degradation``, and sheds the waiting
    queue when the burn flag or the page watermark says the backlog is
    unserviceable. Returns the list of shed requests (usually empty) so
    the caller can post their typed completions."""

    def __init__(self, engine, config=None, name=""):
        self.engine = engine
        self.cfg = config or DegradeConfig()
        self.name = name
        c, e = self.cfg, engine
        mb = e.config.max_batch
        if c.backlog_hi is None:
            c.backlog_hi = 2 * mb
        if c.backlog_lo is None:
            c.backlog_lo = max(1, c.backlog_hi // 4)
        if c.free_pages_lo is None:
            c.free_pages_lo = max(2, e.cache.num_pages // 16)
        if c.free_pages_ok is None:
            c.free_pages_ok = 2 * c.free_pages_lo
        if c.prefill_cap is None:
            c.prefill_cap = max(e.config.page_size,
                                e.config.prefill_token_budget // 4)
        if c.shed_keep is None:
            c.shed_keep = 2 * mb
        self.level = 0
        self._hot = 0
        self._cool = 0
        self.decisions = []          # transition ledger
        self.shed_count = 0
        DEGRADE_LEVEL.set(0)

    # -- signals -------------------------------------------------------------
    def signals(self, burning=False):
        sched = self.engine.scheduler
        return {"backlog": len(sched.waiting),
                "free_pages": self.engine.cache.free_page_count,
                "burning": bool(burning)}

    # -- the beat ------------------------------------------------------------
    def tick(self, burning=False):
        s = self.signals(burning)
        c = self.cfg
        hot = s["burning"] or s["backlog"] > c.backlog_hi \
            or s["free_pages"] < c.free_pages_lo
        cool = (not s["burning"]) and s["backlog"] <= c.backlog_lo \
            and s["free_pages"] >= c.free_pages_ok
        if hot:
            self._hot += 1
            self._cool = 0
        elif cool:
            self._cool += 1
            self._hot = 0
        else:
            self._hot = self._cool = 0
        if hot and self._hot >= c.dwell_beats and self.level < MAX_LEVEL:
            self._transition(self.level + 1, s)
            self._hot = 0
        elif cool and self._cool >= c.recover_beats and self.level > 0:
            self._transition(self.level - 1, s)
            self._cool = 0
        # load shedding: the backlog beyond one refill's worth is
        # unserviceable while the flag burns or the pool is starved —
        # complete it typed NOW instead of letting the deadline sweep
        # (or the eviction storm) burn it down slowly
        shed = []
        sched = self.engine.scheduler
        if (s["burning"] or s["free_pages"] < c.free_pages_lo) \
                and len(sched.waiting) > c.shed_keep:
            reason = "slo_burn" if s["burning"] else "page_watermark"
            shed = sched.shed(len(sched.waiting) - c.shed_keep,
                              reason=reason)
            if shed:
                self.shed_count += len(shed)
                SHED_TOTAL.inc(len(shed))
        return shed

    def _transition(self, new_level, s):
        old = self.level
        with trace.span("serve.degrade", controller=self.name,
                        level_from=old, level_to=new_level, **s):
            self.level = new_level
            self._apply()
        DEGRADE_LEVEL.set(self.level)
        DEGRADE_TRANSITIONS.inc()
        self.decisions.append({"from": old, "to": new_level,
                               "signals": s})

    def _apply(self):
        c = self.cfg
        self.engine.apply_degradation(
            spec_cap=c.spec_cap if self.level >= 1 else None,
            prefill_budget_cap=c.prefill_cap if self.level >= 2 else None,
            max_new_cap=c.max_new_cap if self.level >= 3 else None)
