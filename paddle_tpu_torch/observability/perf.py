"""The StepMeter: per-step accounting of the train step into the metrics
registry, and cross-rank straggler detection over the membership store
(counterpart: ``paddle_tpu/observability/perf.py``).

``StepMeter`` wraps a step (``with perf.METER.step(tokens=, flops=):``)
and records, per step, the wall ms (histogram ``perf_step_ms``), the step
count (``perf_steps_total``), tokens/s (``perf_tokens_per_sec``) and
achieved TF/s (``perf_achieved_tflops``, and ``perf_ceiling_frac``
against ``set_ceiling_tflops``), under the reference's metric names, and
one ``perf.step`` span for the tracer. Step times are on the host clock;
when the meter is on, a step closes with ``torch.cuda.synchronize()``
(where CUDA is initialized) so that the time covers the device's work,
not the enqueue.

Cost contract, as in the reference: disabled (the default; on with
``PADDLE_STEP_METER=1`` or ``enable()``), ``step`` is one attribute check
returning a shared no-op; a step opened inside an open step on the same
thread is the same no-op, so a metered caller around a metered step
counts it once.

The comm meters, as in the reference: when a comm plane is live
(``distributed.comm_plane``, or a provider given to
``set_comm_stats_provider``), each step reads its ``stats()`` at the
start and the end and records the deltas: ``perf_step_comm_ms`` (time
the step's collectives were in flight), ``perf_step_exposed_ms`` (time
the step blocked waiting for them) and ``perf_step_hidden_ms`` (the
rest, hidden behind compute). A provider that raises at the end of a
step is counted (``perf_straggler_check_errors_total``), not raised.

Straggler detection rides the membership store the elastic stack shares
(duck-typed ``set``/``get``/``compare_set``), as in the reference:
``configure_straggler(store, rank, ...)`` makes every ``check_every``-th
step publish the rank's rolling-median step ms under
``__perf/step_ms/r{rank}`` (the rank index ``__perf/ranks`` kept by
``metrics.cas_index``) and fold the fleet's published medians; with three
or more warm ranks, a rank whose median exceeds ``fleet_median + k * MAD``
and ``min_ratio`` times the median is flagged. The first detector wins a
``compare_set`` on ``__perf/straggler``, and every rank that sees the flag
arms triggered tracing: the next ``trace_steps`` steps are traced, then the
trace is exported and a flight-recorder dump names the straggler. A flag
expires after ``PADDLE_STEP_METER_FLAG_TTL`` seconds. A failing store is
counted in ``perf_straggler_check_errors_total``, never raised into the
training loop.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import threading
import time

import torch

from . import flight, metrics, trace

METER_ENV = "PADDLE_STEP_METER"
K_ENV = "PADDLE_STEP_METER_K"                    # MAD multiplier
WINDOW_ENV = "PADDLE_STEP_METER_WINDOW"          # rolling median window
CHECK_EVERY_ENV = "PADDLE_STEP_METER_CHECK_EVERY"
TRACE_STEPS_ENV = "PADDLE_STEP_METER_TRACE_STEPS"
MIN_RATIO_ENV = "PADDLE_STEP_METER_MIN_RATIO"
FLAG_TTL_ENV = "PADDLE_STEP_METER_FLAG_TTL"      # seconds a flag stays live

_PERF_PREFIX = "__perf"
_FLAG_KEY = f"{_PERF_PREFIX}/straggler"

_DEFAULTS = {"k": 4.0, "window": 8, "check_every": 2, "trace_steps": 5,
             "min_ratio": 1.3, "flag_ttl": 600.0}


def _env_float(env, default):
    try:
        return float(os.environ.get(env, default))
    except ValueError:
        return default


class _NullStep:
    """Shared no-op step: the whole disabled or nested cost is returning
    this singleton (plus the caller's ``with`` protocol)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_info(self, **kw):
        return self


NULL_STEP = _NullStep()


class _Step:
    __slots__ = ("_meter", "tokens", "flops", "attrs", "t0", "_comm0")

    def __init__(self, meter, tokens, flops, attrs):
        self._meter = meter
        self.tokens = tokens
        self.flops = flops
        self.attrs = attrs
        self._comm0 = None

    def set_info(self, tokens=None, flops=None, **attrs):
        """Fill in the accounting mid-step (a caller that knows the
        batch only after it started)."""
        if tokens is not None:
            self.tokens = tokens
        if flops is not None:
            self.flops = flops
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        # claimed here, not in step(): if the provider raises, __exit__
        # never runs, and the flag must not stay set
        self._meter._tls.open = True
        provider = self._meter._comm_stats
        try:
            self._comm0 = provider() if provider is not None else None
        except Exception:
            self._meter._tls.open = False
            raise
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._meter._complete(self, time.perf_counter_ns(), exc_type)
        return False


class StepMeter:
    """Per-step accounting into the metrics registry. One instance per
    process (module-level ``METER``)."""

    def __init__(self):
        self.enabled = str(os.environ.get(METER_ENV, "")).strip().lower() \
            not in ("", "0", "false", "off", "no")
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._ceiling_tflops = None
        self._metrics = None
        self._comm_stats = _default_comm_stats
        self._steps = 0
        self._window = collections.deque(
            maxlen=max(int(_env_float(WINDOW_ENV, _DEFAULTS["window"])),
                       2))
        # the straggler check's state (no store until configure_straggler);
        # intervals from the environment are clamped to 1 and more, as the
        # arguments are
        self._store = None
        self._rank = None
        self._k = _env_float(K_ENV, _DEFAULTS["k"])
        self._check_every = max(int(_env_float(CHECK_EVERY_ENV,
                                               _DEFAULTS["check_every"])),
                                1)
        self._trace_steps = max(int(_env_float(TRACE_STEPS_ENV,
                                               _DEFAULTS["trace_steps"])),
                                1)
        self._min_ratio = _env_float(MIN_RATIO_ENV, _DEFAULTS["min_ratio"])
        self._flag_ttl = _env_float(FLAG_TTL_ENV, _DEFAULTS["flag_ttl"])
        self._trace_dir = None
        self._armed = None           # {"straggler", "steps_left", ...}
        self._last_handled = None    # the flag already traced
        self.last_trigger = None     # the last dump's artifacts

    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False

    def set_ceiling_tflops(self, tflops):
        """The device ceiling that ``perf_ceiling_frac`` is taken against
        (for an H100, 989 dense bf16 TF/s at 700 W)."""
        self._ceiling_tflops = float(tflops) if tflops else None
        if self._ceiling_tflops and self._metrics:
            self._metrics["ceiling_tflops"].set(self._ceiling_tflops)
        return self

    def set_comm_stats_provider(self, fn):
        """``fn() -> {"comm_ms":, "exposed_ms":, ...}`` read at each step's
        start and end (default: the live comm plane's ``stats()``)."""
        self._comm_stats = fn
        return self

    def configure_straggler(self, store, rank, k=None, check_every=None,
                            trace_steps=None, trace_dir=None,
                            min_ratio=None, window=None):
        """Arm cross-rank straggler detection over the shared membership
        ``store``: every ``check_every`` steps this rank publishes its
        rolling-median step ms and folds the fleet's (three or more
        published ranks needed). Enables the meter."""
        self._store = store
        self._rank = rank
        if k is not None:
            self._k = float(k)
        if check_every is not None:
            self._check_every = max(int(check_every), 1)
        if trace_steps is not None:
            self._trace_steps = max(int(trace_steps), 1)
        if min_ratio is not None:
            self._min_ratio = float(min_ratio)
        if window is not None:
            self._window = collections.deque(self._window,
                                             maxlen=max(int(window), 2))
        self._trace_dir = trace_dir
        metrics.cas_index(store, f"{_PERF_PREFIX}/ranks", rank,
                          what="perf publish rank index")
        return self.enable()

    def step(self, tokens=None, flops=None, **attrs):
        """Open a metered step (context manager). Disabled: one attribute
        check. Reentrant: a step opened inside an open step on the same
        thread is a shared no-op."""
        if not self.enabled:
            return NULL_STEP
        if getattr(self._tls, "open", False):
            return NULL_STEP
        return _Step(self, tokens, flops, attrs)

    def _ensure_metrics(self):
        m = self._metrics
        if m is None:
            m = self._metrics = {
                "step_ms": metrics.histogram(
                    "perf_step_ms", "train step wall time"),
                "steps": metrics.counter("perf_steps_total"),
                "tokens_per_sec": metrics.gauge("perf_tokens_per_sec"),
                "achieved_tflops": metrics.gauge("perf_achieved_tflops"),
                "ceiling_tflops": metrics.gauge("perf_ceiling_tflops"),
                "ceiling_frac": metrics.gauge("perf_ceiling_frac"),
                "comm_ms": metrics.gauge("perf_step_comm_ms"),
                "exposed_ms": metrics.gauge("perf_step_exposed_ms"),
                "hidden_ms": metrics.gauge("perf_step_hidden_ms"),
                "detections": metrics.counter(
                    "perf_straggler_detections_total"),
                "check_errors": metrics.counter(
                    "perf_straggler_check_errors_total"),
                "straggler_rank": metrics.gauge("perf_straggler_rank"),
            }
            if self._ceiling_tflops:
                m["ceiling_tflops"].set(self._ceiling_tflops)
        return m

    def _complete(self, step, t1, exc_type):
        self._tls.open = False
        step_ms = (t1 - step.t0) / 1e6
        m = self._ensure_metrics()
        span_attrs = dict(step.attrs, step_ms=round(step_ms, 3))
        m["step_ms"].observe(step_ms)
        m["steps"].inc()
        if step._comm0 is not None:
            try:
                c1 = self._comm_stats()
            except Exception:  # counted: a sick provider must not end a step
                c1 = None
                m["check_errors"].inc()
            if c1 is not None:
                comm = c1["comm_ms"] - step._comm0["comm_ms"]
                exposed = c1["exposed_ms"] - step._comm0["exposed_ms"]
                hidden = max(comm - exposed, 0.0)
                m["comm_ms"].set(round(comm, 3))
                m["exposed_ms"].set(round(exposed, 3))
                m["hidden_ms"].set(round(hidden, 3))
                span_attrs["comm_ms"] = round(comm, 3)
                span_attrs["exposed_ms"] = round(exposed, 3)
                span_attrs["hidden_ms"] = round(hidden, 3)
        dt_s = step_ms / 1e3
        if step.tokens is not None and dt_s > 0:
            tps = step.tokens / dt_s
            m["tokens_per_sec"].set(round(tps, 1))
            span_attrs["tokens_per_sec"] = round(tps, 1)
        if step.flops is not None and dt_s > 0:
            tflops = step.flops / dt_s / 1e12
            m["achieved_tflops"].set(round(tflops, 4))
            span_attrs["achieved_tflops"] = round(tflops, 4)
            if self._ceiling_tflops:
                m["ceiling_frac"].set(round(tflops / self._ceiling_tflops,
                                            4))
        if exc_type is not None:
            span_attrs["error"] = exc_type.__name__
        trace.complete_span("perf.step", step.t0, t1, **span_attrs)
        with self._lock:
            self._window.append(step_ms)
            self._steps += 1
            nsteps = self._steps
            armed = self._armed
        if armed is not None:
            armed["steps_left"] -= 1
            if armed["steps_left"] <= 0:
                self._finish_trigger(armed)
        elif self._store is not None and \
                nsteps % self._check_every == 0:
            try:
                self._check_straggler()
            except Exception:  # counted: a sick store must not end training
                m["check_errors"].inc()

    # -- straggler detection --------------------------------------------------
    def _check_straggler(self):
        med = statistics.median(self._window)
        store, rank = self._store, self._rank
        warm = len(self._window) >= (self._window.maxlen or 1)
        store.set(f"{_PERF_PREFIX}/step_ms/r{rank}",
                  json.dumps({"median_ms": med, "steps": self._steps,
                              "warm": warm}))
        # a raised flag wins over recomputing, so every rank (the
        # straggler too) converges on one trigger; a flag older than its
        # TTL (by the wall clock, the one clock comparable across
        # processes) is cleared and detection resumes
        flag = _read_flag(store)
        if flag is not None:
            if time.time() - float(flag.get("ts", 0)) <= self._flag_ttl:
                self._arm(flag)
                return
            _clear_flag(store, flag)
        if not warm:
            return  # a cold window would flag warm-up noise
        vals = {}
        for r in _published_ranks(store):
            try:
                d = json.loads(
                    store.get(f"{_PERF_PREFIX}/step_ms/r{r}").decode())
                if d.get("warm"):
                    vals[r] = float(d["median_ms"])
            except KeyError:
                continue  # registered, not yet published
        if len(vals) < 3:
            return  # a MAD over fewer than three ranks cannot tell noise
        fleet_med = statistics.median(vals.values())
        mad = statistics.median(
            [abs(v - fleet_med) for v in vals.values()])
        threshold = max(fleet_med + self._k * mad,
                        fleet_med * self._min_ratio)
        worst = max(vals, key=lambda r: vals[r])
        if vals[worst] <= threshold:
            return
        info = {"rank": worst, "step_ms": round(vals[worst], 3),
                "fleet_median_ms": round(fleet_med, 3),
                "mad_ms": round(mad, 3), "k": self._k,
                "detector": str(rank), "ts": time.time()}
        _, won = store.compare_set(_FLAG_KEY, "", json.dumps(info))
        if not won:  # another detector won: take the agreed flag
            info = _read_flag(store) or info
        self._arm(info)

    def _arm(self, info):
        """Start triggered tracing: the next ``trace_steps`` steps are
        traced, then exported and flight-dumped naming the straggler."""
        if self._armed is not None or info == self._last_handled:
            return
        m = self._ensure_metrics()
        m["detections"].inc()
        m["straggler_rank"].set(int(info.get("rank", -1))
                                if str(info.get("rank", "")).isdigit()
                                else -1)
        enabled_trace = not trace.TRACER.enabled
        if enabled_trace:
            trace.enable(dir=self._trace_dir)
        enabled_flight = not flight.RECORDER.enabled
        if enabled_flight:
            flight.RECORDER.enabled = True
        trace.event("perf.straggler_flagged", **info)
        self._armed = {"straggler": info,
                       "steps_left": self._trace_steps,
                       "enabled_trace": enabled_trace,
                       "enabled_flight": enabled_flight}

    def _finish_trigger(self, armed):
        info = armed["straggler"]
        d = self._trace_dir
        if d is None:
            d = os.environ.get(trace.TRACE_DIR_ENV) or None
        trace_path = None
        try:
            if d is not None:
                os.makedirs(d, exist_ok=True)
                trace_path = trace.TRACER.export(
                    os.path.join(d, f"trace.{os.getpid()}.json"))
            else:
                trace_path = trace.TRACER.export()
        except Exception:
            pass  # a full disk must not end training; the dump follows
        flight_path = None
        path = None if d is None else os.path.join(
            d, f"flight.straggler.{os.getpid()}.{self._rank}.json")
        was_flight = flight.RECORDER.enabled
        try:
            # the dump is the trigger's point: force it even if another
            # meter turned the shared recorder off meanwhile
            flight.RECORDER.enabled = True
            flight_path = flight.RECORDER.dump(
                path=path, reason=f"straggler: rank {info.get('rank')}",
                straggler=info, detector_rank=str(self._rank))
        except Exception:
            pass
        finally:
            flight.RECORDER.enabled = was_flight
        if armed["enabled_trace"]:
            trace.disable()
        if armed["enabled_flight"]:
            flight.RECORDER.enabled = False
        self.last_trigger = {"straggler": info, "trace_path": trace_path,
                             "flight_path": flight_path}
        self._last_handled = info
        self._armed = None

    def armed(self):
        return self._armed is not None

    def reset(self):
        """Forget steps, window and trigger state (the metrics' series
        stay: clear the registry apart)."""
        with self._lock:
            self._steps = 0
            self._window.clear()
            self._armed = None
            self._last_handled = None
            self.last_trigger = None


def _published_ranks(store):
    try:
        raw = store.get(f"{_PERF_PREFIX}/ranks").decode()
    except KeyError:
        return []
    return sorted(r for r in raw.split(",") if r)


def _read_flag(store):
    try:
        raw = store.get(_FLAG_KEY).decode()
    except KeyError:
        return None
    if not raw:
        return None  # a cleared flag
    try:
        return json.loads(raw)
    except ValueError:
        return None  # a torn write: no flag


def _clear_flag(store, expected):
    """Best effort: an expired flag back to empty by ``compare_set`` (a
    new flag raised meanwhile wins and stays)."""
    try:
        raw = store.get(_FLAG_KEY).decode()
        if json.loads(raw) == expected:
            store.compare_set(_FLAG_KEY, raw, "")
    except Exception:
        pass  # at worst a stale flag the TTL check keeps ignoring


def _default_comm_stats():
    """The live comm plane's ``stats()``, when its module is already
    imported and a plane exists in this process (never imports it)."""
    mod = sys.modules.get(
        __name__.split(".")[0] + ".distributed.comm_plane")
    if mod is None:
        return None
    plane = mod.live_plane()
    return None if plane is None else plane.stats()


METER = StepMeter()

step = METER.step
configure_straggler = METER.configure_straggler
set_ceiling_tflops = METER.set_ceiling_tflops
set_comm_stats_provider = METER.set_comm_stats_provider


def enable():
    return METER.enable()


def disable():
    METER.disable()


def enabled():
    return METER.enabled
