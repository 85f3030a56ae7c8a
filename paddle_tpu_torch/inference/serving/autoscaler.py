"""Fleet autoscaler: a model-checked policy loop over signals the
serving plane already publishes (counterpart:
``paddle_tpu/inference/serving/autoscaler.py``).

The fleet reacted before it planned: replicas joined when an operator
spawned them and left when an operator drained them, while the signals
a planner needs — per-replica occupancy/free-page gauges,
router backlog, SLO burn rates — were already on the store.
This module closes the loop:

- **scale OUT** when the fleet is under pressure: routed-but-waiting
  backlog, free KV pages under the low-water mark, or an SLO burn-rate
  breach. Actuation = an injected ``spawn`` callable (the benchmark
  launches a replica process; production launches a pod). When a
  compile cache is configured, the prewarm hook runs FIRST, so the new
  N+1th-world replica attaches warm (part 1's promise, kept here).
- **scale IN** when the fleet has been idle for ``idle_ticks`` policy
  beats: pick the least-loaded serving replica and retire it through
  the EXISTING drain protocol (``ServingRouter.drain`` — stop
  admissions, finish in-flight, re-route the never-admitted tail,
  fence by generation bump). Scale-in is therefore exactly as safe as
  drain — which is exactly what paddlecheck proves: the
  ``serving_router`` model fires the REAL ``scale_in`` actuation at
  every explorable point of the route/admit/complete window and audits
  the same F1–F4 invariants (admit-while-serving, all-complete,
  exactly-once, clean exits).
- **never below min**: the floor is enforced at ACTUATION time against
  a live-target count, not at decision time — an autoscaler racing an
  operator drain or a failover holds instead of scaling the fleet to
  zero (the model checker's 2-injection composition).

The policy itself is deterministic arithmetic (auditable from the
``decisions`` ledger); every actuation is wrapped in a ``fleet.scale``
span (docs/OBSERVABILITY.md) with direction, reason and fleet size.

Env knobs (docs/SERVING.md, all ``PADDLE_SERVE_AS_*``): MIN/MAX
(fleet bounds, default 1/4), OUT_FREE_PAGES (low-water mark, default
8), OUT_BACKLOG (waiting threshold, default 1), IDLE_TICKS (beats of
zero load before scale-in, default 3), COOLDOWN (seconds between
actuations, default 5).

Jax-free and engine-free by construction (it talks only to the router
and the store views), so paddlecheck explores this exact code.
"""
from __future__ import annotations

import os

from ...observability import metrics, trace

SCALE_OUTS = metrics.counter(
    "serving_autoscaler_scale_outs", "replicas spawned by the autoscaler")
SCALE_INS = metrics.counter(
    "serving_autoscaler_scale_ins", "replicas drained by the autoscaler")
FLEET_TARGET = metrics.gauge(
    "serving_autoscaler_fleet", "serving replicas at the last policy beat")


class AutoscalerConfig:
    def __init__(self, min_replicas=None, max_replicas=None,
                 out_free_pages=None, out_backlog=None, idle_ticks=None,
                 cooldown_s=None):
        env = os.environ.get

        def knob(val, name, default, cast=int):
            return cast(val if val is not None
                        else env(f"PADDLE_SERVE_AS_{name}", default))

        self.min_replicas = knob(min_replicas, "MIN", 1)
        self.max_replicas = knob(max_replicas, "MAX", 4)
        self.out_free_pages = knob(out_free_pages, "OUT_FREE_PAGES", 8)
        self.out_backlog = knob(out_backlog, "OUT_BACKLOG", 1)
        self.idle_ticks = knob(idle_ticks, "IDLE_TICKS", 3)
        self.cooldown_s = knob(cooldown_s, "COOLDOWN", 5.0, float)
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1: a serving "
                             "fleet never scales to zero by policy")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas < min_replicas")


class Autoscaler:
    """The planning loop (module doc). ``router`` is the fleet's
    ``ServingRouter``; ``spawn`` is the scale-out actuator (callable,
    no args — may be None to run scale-in-only); ``prewarm`` runs
    before every spawn (the compile-cache warm-ahead hook); ``slo``
    is an ``observability.slo.SLOEngine`` or None."""

    def __init__(self, router, spawn=None, config=None, slo=None,
                 prewarm=None):
        self.router = router
        self.spawn = spawn
        self.config = config or AutoscalerConfig()
        self.slo = slo
        self.prewarm = prewarm
        self._clock = router._clock
        self._cooldown_until = 0.0
        self._idle_beats = 0
        self.decisions = []        # audit ledger: every beat's verdict
        self.scale_outs = 0
        self.scale_ins = 0

    # -- signals -------------------------------------------------------------
    def _signals(self, targets):
        occ = [t.occ or {} for t in targets]
        waiting = sum(int(o.get("waiting", 0)) for o in occ)
        running = sum(int(o.get("running", 0)) for o in occ)
        free = [t.free_pages for t in targets]
        burning = bool(self.slo.evaluate()) if self.slo is not None \
            else False
        return {
            "n": len(targets),
            "backlog": waiting + len(self.router.pending),
            "running": running,
            "min_free_pages": min(free) if free else 0,
            "slo_burning": burning,
            # degradation composes with scale-out — a replica
            # publishing a brownout level is shedding quality (and
            # probably load) to survive; capacity is the real fix
            "degrade_level": max(
                [int(o.get("degrade_level", 0)) for o in occ],
                default=0),
        }

    # -- policy --------------------------------------------------------------
    def _decide(self, sig):
        """(direction, reason) off one signal snapshot — pure
        arithmetic, no I/O, auditable from the ledger."""
        c = self.config
        if sig["n"] < c.min_replicas:
            return "out", "below-min"
        if sig["n"] < c.max_replicas:
            if sig["slo_burning"]:
                return "out", "slo-burn"
            if sig.get("degrade_level", 0) > 0:
                return "out", f"degraded:{sig['degrade_level']}"
            if sig["backlog"] >= c.out_backlog:
                return "out", f"backlog:{sig['backlog']}"
            if sig["min_free_pages"] <= c.out_free_pages:
                return "out", f"low-pages:{sig['min_free_pages']}"
        if sig["n"] > c.min_replicas and sig["running"] == 0 \
                and sig["backlog"] == 0:
            self._idle_beats += 1
            if self._idle_beats >= c.idle_ticks:
                return "in", f"idle:{self._idle_beats}"
            return "hold", f"idling:{self._idle_beats}"
        self._idle_beats = 0
        return "hold", "steady"

    # -- actuation -----------------------------------------------------------
    def scale_out(self, reason="forced"):
        """Spawn one replica (prewarm first — the new world attaches
        warm). Returns True when a spawn was actuated."""
        targets = self.router._targets(self.router.discover())
        n = len(targets)
        if self.spawn is None or n >= self.config.max_replicas:
            return False
        with trace.span("fleet.scale", direction="out", reason=reason,
                        n_before=n):
            if self.prewarm is not None:
                self.prewarm()
            self.spawn()
        self.scale_outs += 1
        SCALE_OUTS.inc()
        self._cooldown_until = self._clock.monotonic() \
            + self.config.cooldown_s
        return True

    def scale_in(self, reason="forced"):
        """Retire the least-loaded serving replica through the drain
        protocol. The min-replica floor is checked HERE, against the
        live target count at actuation time: racing an operator drain
        or a failover, the autoscaler holds rather than helping scale
        the fleet to zero. Returns the drained replica id or None."""
        targets = self.router._targets(self.router.discover())
        if len(targets) <= self.config.min_replicas:
            self.decisions.append(("held-at-min", len(targets)))
            return None
        victim = min(
            targets,
            key=lambda v: (int(v.occ.get("running", 0))
                           + int(v.occ.get("waiting", 0)),
                           -v.free_pages, v.i))
        with trace.span("fleet.scale", direction="in", reason=reason,
                        replica=victim.i, n_before=len(targets)):
            self.router.drain(victim.i, reason=f"autoscale:{reason}")
        self.scale_ins += 1
        SCALE_INS.inc()
        self._idle_beats = 0
        self._cooldown_until = self._clock.monotonic() \
            + self.config.cooldown_s
        return victim.i

    # -- the loop ------------------------------------------------------------
    def tick(self):
        """One policy beat: snapshot signals, decide, actuate. Returns
        the (direction, reason) verdict."""
        targets = self.router._targets(self.router.discover())
        FLEET_TARGET.set(len(targets))
        if self._clock.monotonic() < self._cooldown_until:
            return ("hold", "cooldown")
        sig = self._signals(targets)
        direction, reason = self._decide(sig)
        self.decisions.append((direction, reason, sig))
        if direction == "out":
            if not self.scale_out(reason):
                return ("hold", "out-bound")
        elif direction == "in":
            if self.scale_in(reason) is None:
                return ("hold", "held-at-min")
        return (direction, reason)

    def run(self, stop, interval=1.0):
        """Drive ``tick`` until ``stop`` (a threading.Event) is set —
        the standalone loop; embedders usually call ``tick`` from the
        router's own poll cadence instead."""
        while not stop.is_set():
            self.tick()
            self._clock.sleep(float(interval))
