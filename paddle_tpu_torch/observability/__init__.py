"""Host-side telemetry for the port (counterpart:
``paddle_tpu.observability``):

- ``trace``   — nested thread-safe spans/events, chrome-trace export,
  cross-process merge (``PADDLE_TRACE`` / ``PADDLE_TRACE_DIR``);
- ``metrics`` — labeled counters/gauges/histograms with a store-backed
  fleet ``publish()``/``fleet_snapshot()``;
- ``flight``  — bounded ring of recent records, dumped on
  crash/SIGTERM/SIGINT/teardown;
- ``perf``    — the single-process StepMeter;
- ``requesttrace`` — request-scoped serving-plane tracing: rid
  propagation, the cross-process clock-anchor merge pass,
  ``request_timeline``;
- ``expo``    — live Prometheus ``/metrics`` exposition and
  store-announced endpoint discovery;
- ``slo``     — declared request SLOs over sliding windows with
  multi-window burn-rate alerting and the fleet-wide burn flag.

Every module but ``perf`` is a stdlib copy of its reference; this
package wires them together as the reference does (completed spans feed
the flight ring).
"""
from __future__ import annotations

from . import expo, flight, metrics, perf, requesttrace, slo, trace

# completed spans/events flow into the flight ring so a dump carries the
# last N spans even if the trace buffer never got exported
trace.add_sink(flight.RECORDER.trace_sink)

__all__ = ["trace", "metrics", "flight", "perf", "expo", "requesttrace",
           "slo"]
