"""The StepMeter: per-step accounting of the train step into the metrics
registry (counterpart: ``paddle_tpu/observability/perf.py``, its
single-process part).

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

Not in this slice: the reference's cross-rank straggler detection over
the membership store with triggered tracing: ``configure_straggler``
raises ``NotImplementedError`` (ROADMAP A8).
"""
from __future__ import annotations

import os
import sys
import threading
import time

import torch

from . import metrics, trace

METER_ENV = "PADDLE_STEP_METER"


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
        self._ceiling_tflops = None
        self._metrics = None
        self._comm_stats = _default_comm_stats

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

    def configure_straggler(self, store, rank, **kwargs):
        raise NotImplementedError(
            "cross-rank straggler detection needs the membership store, "
            "which the port has not yet (ROADMAP A8)")

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
                "check_errors": metrics.counter(
                    "perf_straggler_check_errors_total"),
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
