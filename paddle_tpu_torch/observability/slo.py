"""SLO engine: declared request-level objectives evaluated over
sliding windows with multi-window burn-rate alerting; a breach
CAS-publishes a fleet-wide flag that arms triggered tracing and a
flight dump naming the offending requests (a copy of
``paddle_tpu/observability/slo.py``).

Model (the SRE burn-rate shape, scaled to this fleet's tempo):

- an ``Objective`` declares a GOOD-fraction target over request
  completions — ``availability`` (status == ok) or ``latency``
  (value ≤ threshold_ms; a failed completion counts bad here too: a
  request that never produced a first token did not meet the TTFT
  SLO). The error budget is ``1 − target``.
- every completion is judged per objective into per-objective sliding
  event windows; ``evaluate()`` computes, per declared
  ``(window_s, burn_threshold)`` pair, the burn rate
  ``bad_fraction / budget`` over that window. A BREACH requires EVERY
  window to burn past its threshold with at least ``min_events``
  events — the long window proves the burn is material, the short one
  proves it is still happening (the classic multi-window AND that
  suppresses both blips and stale pages).
- on breach, ``tick(store)`` CAS-publishes ``__slo/breach`` on the
  shared membership store: exactly ONE process fleet-wide wins the
  raise (the counter ``slo_breaches_flagged_total`` counts winners
  only). Every process that sees the flag — router and replicas —
  arms TRIGGERED TRACING: tracing/flight turn on for ``trace_for_s``
  seconds, then each process exports its trace shard and dumps a
  flight artifact (``flight.slo.<pid>.json``) whose meta carries the
  flag and the last-N per-request records naming the offending
  requests. A handled flag never re-arms; flags expire after
  ``PADDLE_SLO_FLAG_TTL`` seconds so one breach cannot mute a later
  one.

Cost contract: a serving loop holds ``slo=None`` by default — the
integration cost is one attribute check. With an engine attached,
``tick()`` is one monotonic comparison between evaluation intervals.

Pure stdlib + intra-package imports (standalone-importable, the
trace.py constraint); the store is duck-typed
(``get``/``set``/``compare_set``), never imported.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

from . import flight, metrics, trace
from .flight import _truthy


def _env_float(env, default):
    try:
        return float(os.environ.get(env, default))
    except ValueError:
        return default

SLO_ENV = "PADDLE_SLO"                    # truthy → from_env() builds
TTFT_MS_ENV = "PADDLE_SLO_TTFT_MS"        # latency threshold (ms)
TTFT_TARGET_ENV = "PADDLE_SLO_TTFT_TARGET"
AVAIL_TARGET_ENV = "PADDLE_SLO_AVAIL_TARGET"
WINDOWS_ENV = "PADDLE_SLO_WINDOWS"        # "60:6,300:3" = s:burn pairs
MIN_EVENTS_ENV = "PADDLE_SLO_MIN_EVENTS"
TRACE_S_ENV = "PADDLE_SLO_TRACE_S"        # triggered-tracing duration
LAST_N_ENV = "PADDLE_SLO_LAST_N"          # request records per dump
FLAG_TTL_ENV = "PADDLE_SLO_FLAG_TTL"

_SLO_PREFIX = "__slo"
_FLAG_KEY = f"{_SLO_PREFIX}/breach"

_DEFAULTS = {"ttft_ms": 250.0, "ttft_target": 0.99,
             "avail_target": 0.999, "windows": ((60.0, 6.0), (300.0, 3.0)),
             "min_events": 10, "trace_s": 5.0, "last_n": 256,
             "flag_ttl": 600.0, "eval_interval": 0.25}


def parse_windows(spec):
    """``"60:6,300:3"`` → ((60.0, 6.0), (300.0, 3.0))."""
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        w, _, b = part.partition(":")
        out.append((float(w), float(b) if b else 1.0))
    if not out:
        raise ValueError(f"empty SLO window spec: {spec!r}")
    return tuple(out)


class Objective:
    """One declared objective. ``threshold_ms`` set → a LATENCY
    objective over ``value_key`` (default ttft_ms); unset → an
    AVAILABILITY objective over the completion status."""

    def __init__(self, name, target, threshold_ms=None,
                 value_key="ttft_ms", windows=None, min_events=None):
        self.name = str(name)
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"objective {name}: target must be in (0, 1), "
                f"got {target!r}")
        self.budget = 1.0 - self.target
        self.threshold_ms = None if threshold_ms is None \
            else float(threshold_ms)
        self.value_key = value_key
        self.windows = tuple((float(w), float(b)) for w, b in
                             (windows or _DEFAULTS["windows"]))
        self.min_events = int(min_events if min_events is not None
                              else _DEFAULTS["min_events"])
        self.max_window_s = max(w for w, _ in self.windows)

    def judge(self, record):
        """True = good, False = bad, None = not judged by this
        objective (e.g. a latency objective over a record with no
        value and an ok status — nothing to say)."""
        ok_status = record.get("status", "ok") == "ok"
        if self.threshold_ms is None:
            return ok_status
        v = record.get(self.value_key)
        if v is None:
            return False if not ok_status else None
        return float(v) <= self.threshold_ms

    def describe(self):
        d = {"name": self.name, "target": self.target,
             "windows": [list(w) for w in self.windows]}
        if self.threshold_ms is not None:
            d["threshold_ms"] = self.threshold_ms
            d["value_key"] = self.value_key
        return d


class SLOEngine:
    """Records completions, evaluates objectives, raises/handles the
    fleet-wide breach flag (see module docstring). One instance per
    serving process (router or replica)."""

    def __init__(self, objectives, name=None, trace_dir=None,
                 trace_for_s=None, last_n=None, eval_interval=None,
                 flag_ttl=None):
        if not objectives:
            raise ValueError("SLOEngine needs at least one Objective")
        self.objectives = list(objectives)
        self.name = name or f"pid{os.getpid()}"
        self._trace_dir = trace_dir
        self.trace_for_s = float(
            trace_for_s if trace_for_s is not None
            else _env_float(TRACE_S_ENV, _DEFAULTS["trace_s"]))
        self.last_n = int(last_n if last_n is not None
                          else _env_float(LAST_N_ENV,
                                          _DEFAULTS["last_n"]))
        self.eval_interval = float(
            eval_interval if eval_interval is not None
            else _DEFAULTS["eval_interval"])
        self._flag_ttl = float(
            flag_ttl if flag_ttl is not None
            else _env_float(FLAG_TTL_ENV, _DEFAULTS["flag_ttl"]))
        self._lock = threading.Lock()
        self._events = {o.name: collections.deque()
                        for o in self.objectives}
        self.requests = collections.deque(maxlen=self.last_n)
        self._next_eval = 0.0
        self._armed = None
        self._last_handled = None
        self.last_trigger = None
        m = metrics
        self._m = {
            "requests": m.counter("slo_requests_total",
                                  "completions judged by the SLO engine"),
            "bad": m.counter("slo_bad_events_total",
                             "budget-burning events per objective"),
            "burn": m.gauge("slo_burn_rate",
                            "burn rate per (objective, window)"),
            "flag_raises": m.counter(
                "slo_breaches_flagged_total",
                "breach flags RAISED by this process (CAS winners "
                "only — fleet sum is the exactly-once proof)"),
            "armed": m.counter("slo_triggered_arms_total",
                               "times this process armed triggered "
                               "tracing off a breach flag"),
            "errors": m.counter("slo_check_errors_total",
                                "store failures inside tick (counted, "
                                "never raised into the serve loop)"),
        }

    # -- recording -----------------------------------------------------------
    def record_request(self, rid=None, ttft_ms=None, status="ok",
                       replica=None, now=None, **extra):
        """Judge one completion against every objective."""
        now = time.monotonic() if now is None else now
        rec = {"rid": None if rid is None else str(rid),
               "ttft_ms": ttft_ms, "status": status,
               "replica": replica, "ts_unix": time.time()}
        rec.update(extra)
        bad_for = []
        with self._lock:
            for obj in self.objectives:
                ok = obj.judge(rec)
                if ok is None:
                    continue
                self._events[obj.name].append((now, ok))
                if not ok:
                    bad_for.append(obj.name)
            rec["bad_for"] = bad_for
            self.requests.append(rec)
        self._m["requests"].inc()
        for name in bad_for:
            self._m["bad"].inc(objective=name)

    # -- evaluation ----------------------------------------------------------
    def _prune(self, obj, now):
        dq = self._events[obj.name]
        horizon = now - obj.max_window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def evaluate(self, now=None):
        """Burn-rate verdicts; returns the list of breached objectives
        (each a dict naming burn per window)."""
        now = time.monotonic() if now is None else now
        breaches = []
        with self._lock:
            for obj in self.objectives:
                self._prune(obj, now)
                events = list(self._events[obj.name])
                burns = []
                breach = bool(events)
                for w, thr in obj.windows:
                    inw = [ok for t, ok in events if t >= now - w]
                    n = len(inw)
                    bad_frac = (inw.count(False) / n) if n else 0.0
                    burn = bad_frac / obj.budget
                    self._m["burn"].set(round(burn, 4),
                                        objective=obj.name,
                                        window=f"{w:g}s")
                    burns.append({"window_s": w, "events": n,
                                  "bad_frac": round(bad_frac, 4),
                                  "burn": round(burn, 3),
                                  "threshold": thr})
                    if n < obj.min_events or burn <= thr:
                        breach = False
                if breach:
                    breaches.append({"objective": obj.name,
                                     **obj.describe(),
                                     "burns": burns})
        return breaches

    # -- the fleet flag ------------------------------------------------------
    def tick(self, store, now=None):
        """One control-loop beat: between eval intervals this is one
        monotonic comparison; on the interval it evaluates, follows or
        raises the fleet flag, and progresses an armed trigger."""
        now = time.monotonic() if now is None else now
        if self._armed is not None and now >= self._armed["until"]:
            self._finish_trigger()
        if now < self._next_eval:
            return
        self._next_eval = now + self.eval_interval
        try:
            self._check(store, now)
        # a sick store must never kill the serve loop from inside its
        # telemetry; the failure is counted and fleet monitoring sees the
        # counter
        except Exception:
            self._m["errors"].inc()

    def _check(self, store, now):
        # evaluate FIRST, unconditionally: the slo_burn_rate gauges
        # must stay live while a flag is up — an operator scraping
        # /metrics mid-incident reads the CURRENT burn, not a value
        # frozen at flag-raise time for the whole TTL
        breaches = self.evaluate(now)
        flag = _read_flag(store)
        if flag is not None:
            # the flag's ts was stamped by ANOTHER process; wall clock is the
            # only cross-process-comparable base, and a clock step at worst
            # expires a flag early (one extra evaluation round) or late
            # (bounded by the TTL) — the straggler-flag precedent
            if time.time() - float(flag.get("ts", 0)) <= self._flag_ttl:
                self._arm(flag)
                return
            _clear_flag(store, flag)
        if not breaches:
            return
        info = {"detector": self.name, "ts": time.time(),
                "breaches": breaches,
                "offending": self.offending(limit=8)}
        _, won = store.compare_set(_FLAG_KEY, "", json.dumps(info))
        if won:
            # the exactly-once-fleet-wide raise: CAS admits one winner
            self._m["flag_raises"].inc()
        else:
            info = _read_flag(store) or info
        self._arm(info)

    def offending(self, limit=32):
        """The most recent budget-burning request records (what the
        flight dump names)."""
        with self._lock:
            bad = [r for r in self.requests if r.get("bad_for")]
        return bad[-limit:]

    # -- triggered tracing (the straggler arm/finish shape) ------------
    def _arm(self, flag):
        if self._armed is not None or flag == self._last_handled:
            return
        self._m["armed"].inc()
        enabled_trace = not trace.TRACER.enabled
        if enabled_trace:
            trace.enable(dir=self._trace_dir)
        enabled_flight = not flight.RECORDER.enabled
        if enabled_flight:
            flight.RECORDER.enabled = True
        trace.event("slo.breach_flagged",
                    detector=flag.get("detector"),
                    objectives=[b.get("objective")
                                for b in flag.get("breaches", [])])
        self._armed = {"flag": flag,
                       "until": time.monotonic() + self.trace_for_s,
                       "enabled_trace": enabled_trace,
                       "enabled_flight": enabled_flight}

    def _finish_trigger(self):
        armed, self._armed = self._armed, None
        flag = armed["flag"]
        d = self._trace_dir or os.environ.get(trace.TRACE_DIR_ENV) or None
        trace_path = None
        try:
            if d is not None:
                os.makedirs(d, exist_ok=True)
                trace_path = trace.TRACER.export(
                    os.path.join(d, f"trace.{os.getpid()}.json"))
            else:
                trace_path = trace.TRACER.export()
        # artifact best effort: a full disk must not kill the serve loop; the
        # flight dump below still carries the request records
        except Exception:
            pass
        flight_path = None
        path = None if d is None else os.path.join(
            d, f"flight.slo.{os.getpid()}.json")
        was_flight = flight.RECORDER.enabled
        try:
            flight.RECORDER.enabled = True
            flight_path = flight.RECORDER.dump(
                path=path, reason="slo breach",
                slo=flag, offending=self.offending())
        # artifact best effort, as above; the trace export may already have
        # landed
        except Exception:
            pass
        finally:
            flight.RECORDER.enabled = was_flight
        if armed["enabled_trace"]:
            trace.disable()
        if armed["enabled_flight"]:
            flight.RECORDER.enabled = False
        self.last_trigger = {"flag": flag, "trace_path": trace_path,
                             "flight_path": flight_path}
        self._last_handled = flag

    def armed(self):
        return self._armed is not None


def _read_flag(store):
    try:
        raw = store.get(_FLAG_KEY).decode()
    except KeyError:
        return None
    if not raw:
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return None      # torn write: treat as no flag


def flag_up(store, ttl=None):
    """Read-only verdict on the fleet breach flag: True while a FRESH
    flag is raised (the same TTL rule ``_check`` applies). The
    shedding/degradation controllers poll this — they react to the
    exactly-once CAS raise without ever competing for it."""
    flag = _read_flag(store)
    if flag is None:
        return False
    if ttl is None:
        ttl = _env_float(FLAG_TTL_ENV, _DEFAULTS["flag_ttl"])
    # the flag ts was stamped by another process; wall clock is the only cross-
    # process-comparable base and staleness here only gates a REACTION, not
    # correctness (the _check precedent)
    return time.time() - float(flag.get("ts", 0)) <= float(ttl)


def _clear_flag(store, expected):
    """Best-effort CAS of an expired flag back to empty (a concurrent
    fresh flag wins the race and stays)."""
    try:
        raw = store.get(_FLAG_KEY).decode()
        if json.loads(raw) == expected:
            store.compare_set(_FLAG_KEY, raw, "")
    # expiry cleanup is best-effort hygiene; losing the race (or the store)
    # leaves at worst a stale flag the TTL check keeps ignoring
    except Exception:
        pass


def default_objectives():
    """The serving plane's stock objectives off the env knobs: TTFT
    latency (p-target fraction under the threshold) + availability."""
    windows = parse_windows(os.environ.get(WINDOWS_ENV, "")) \
        if os.environ.get(WINDOWS_ENV) else _DEFAULTS["windows"]
    min_events = int(_env_float(MIN_EVENTS_ENV, _DEFAULTS["min_events"]))
    return [
        Objective("ttft",
                  target=_env_float(TTFT_TARGET_ENV,
                                    _DEFAULTS["ttft_target"]),
                  threshold_ms=_env_float(TTFT_MS_ENV,
                                          _DEFAULTS["ttft_ms"]),
                  windows=windows, min_events=min_events),
        Objective("availability",
                  target=_env_float(AVAIL_TARGET_ENV,
                                    _DEFAULTS["avail_target"]),
                  windows=windows, min_events=min_events),
    ]


def from_env(name=None):
    """The serving processes' wiring point: None unless ``PADDLE_SLO``
    is truthy (the one-attribute-check disabled mode), else an engine
    over ``default_objectives()``."""
    if not _truthy(os.environ.get(SLO_ENV, "")):
        return None
    return SLOEngine(default_objectives(), name=name)
