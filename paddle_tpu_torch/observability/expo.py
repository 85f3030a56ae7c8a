"""Live metrics exposition: a Prometheus-text ``/metrics`` endpoint +
store-announced endpoint discovery (a copy of
``paddle_tpu/observability/expo.py``).

Until now a running fleet exposed telemetry only at teardown (the
store publish). This module makes a LIVE process inspectable:

- ``render_prometheus(snapshot)`` — the registry snapshot in Prometheus
  text exposition format v0.0.4 (``# TYPE`` lines, label escaping,
  histogram ``_bucket``/``_sum``/``_count`` triplets with cumulative
  ``le`` buckets ending in ``+Inf``);
- ``MetricsServer`` — a stdlib ``ThreadingHTTPServer`` on a daemon
  thread serving ``/metrics`` (Prometheus text), ``/snapshot.json``
  (the raw registry snapshot, what ``observability.top`` consumes) and
  ``/healthz``. PULL model: the hot paths pay nothing per scrape —
  a GET reads the registry under its own locks;
- store discovery: ``announce(store, name, addr)`` registers an
  endpoint under ``__expo`` on the membership store the fleet already
  shares; ``endpoints(store)`` lists them — how
  ``python -m paddle_tpu_torch.observability.top`` finds a fleet.

DISABLED COST CONTRACT (same style as trace/perf): with
``PADDLE_METRICS_PORT`` unset, ``start_if_configured()`` is one module
attribute + one cached env check returning None — no socket, no
thread; serving processes call it once at attach, never per loop.
Set ``PADDLE_METRICS_PORT=0`` for an ephemeral port (fleets of many
replicas per host), or a concrete port for a fixed scrape target.

Pure stdlib, standalone-importable (same constraint as trace.py).
"""
from __future__ import annotations

import json
import math
import os
import threading

from . import metrics

METRICS_PORT_ENV = "PADDLE_METRICS_PORT"
METRICS_HOST_ENV = "PADDLE_METRICS_HOST"

_EXPO_PREFIX = "__expo"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# -- Prometheus text rendering ------------------------------------------------

def _escape_label(v):
    return str(v).replace("\\", "\\\\").replace("\n", "\\n") \
        .replace('"', '\\"')


def _escape_help(v):
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _fmt_le(ub):
    return "+Inf" if ub is None else _fmt_value(float(ub))


def render_prometheus(snapshot=None):
    """A registry snapshot (default: the live process registry) as
    Prometheus text exposition format v0.0.4."""
    snap = metrics.REGISTRY.snapshot() if snapshot is None else snapshot
    lines = []
    for name, m in sorted(snap.get("metrics", {}).items()):
        kind = m.get("kind", "gauge")
        if kind not in ("counter", "gauge", "histogram"):
            continue
        if m.get("help"):
            lines.append(f"# HELP {name} {_escape_help(m['help'])}")
        lines.append(f"# TYPE {name} {kind}")
        for s in m.get("series", []):
            labels = dict(s.get("labels", {}))
            if kind == "histogram":
                bounds = list(m.get("bounds", []))
                cum = 0
                for i, ub in enumerate(bounds + [None]):
                    cum += s["buckets"][i]
                    lb = dict(labels, le=_fmt_le(ub))
                    lines.append(
                        f"{name}_bucket{_fmt_labels(lb)} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(s['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{s['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} "
                             f"{_fmt_value(s['value'])}")
    return "\n".join(lines) + "\n"


# -- the HTTP server ----------------------------------------------------------

class MetricsServer:
    """Serve ``/metrics`` + ``/snapshot.json`` + ``/healthz`` off a
    registry, on a daemon thread. ``start()`` binds (port 0 =
    ephemeral) and returns self; ``address`` is the scrapeable
    ``host:port``."""

    def __init__(self, registry=None, host=None, port=0):
        self.registry = registry if registry is not None \
            else metrics.REGISTRY
        self.host = host or os.environ.get(METRICS_HOST_ENV,
                                           "127.0.0.1")
        self.port = int(port)
        self._httpd = None
        self._thread = None

    def start(self):
        import http.server
        registry = self.registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?", 1)[0] == "/metrics":
                    body = render_prometheus(
                        registry.snapshot()).encode()
                    ctype = CONTENT_TYPE
                elif self.path.split("?", 1)[0] == "/snapshot.json":
                    body = json.dumps(registry.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.split("?", 1)[0] == "/healthz":
                    body = b"ok\n"
                    ctype = "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # scrapes are not log lines
                pass

        # a wedged/half-open scraper must never hold a handler thread
        # forever: StreamRequestHandler.timeout sets the per-connection
        # socket deadline (the SERVER's .timeout only affects
        # handle_request(), which serve_forever never consults)
        Handler.timeout = 5.0

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-expo",
            daemon=True)
        self._thread.start()
        return self

    @property
    def address(self):
        return f"{self.host}:{self.port}"

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


SERVER = None          # the process's auto-started server, if any
_CONFIGURED = None     # cached env verdict (None = not yet read)


def start_if_configured():
    """Start (once) and return the process metrics server when
    ``PADDLE_METRICS_PORT`` is set; None otherwise. The disabled path
    is one attribute check against the cached env verdict."""
    global SERVER, _CONFIGURED
    if _CONFIGURED is None:
        _CONFIGURED = os.environ.get(METRICS_PORT_ENV, "") != ""
    if not _CONFIGURED:
        return None
    if SERVER is None:
        SERVER = MetricsServer(
            port=int(os.environ.get(METRICS_PORT_ENV, "0"))).start()
    return SERVER


def serve_metrics(port=0, registry=None):
    """Explicitly start a metrics server (tests, routers, notebooks)."""
    return MetricsServer(registry=registry, port=port).start()


# -- store-announced discovery ------------------------------------------------

def announce(store, name, address, attempts=64):
    """Register ``name -> host:port`` under ``__expo`` on the shared
    membership store (the shared ``metrics.cas_index`` loop)."""
    store.set(f"{_EXPO_PREFIX}/ep/{name}", str(address))
    metrics.cas_index(store, f"{_EXPO_PREFIX}/eps", name,
                      attempts=attempts, what="expo announce")


def unannounce(store, name, attempts=64):
    """Retire an endpoint (graceful departure)."""
    store.set(f"{_EXPO_PREFIX}/ep/{name}", "")
    metrics.cas_index(store, f"{_EXPO_PREFIX}/eps", name, add=False,
                      attempts=attempts, what="expo unannounce")


def retire_if_current(store, name, address, attempts=64):
    """Retire ``name`` ONLY while it still points at ``address`` (CAS):
    a third party cleaning up after a corpse (the router's death
    verdict) must never blank a restarted same-name process's FRESH
    announce. Returns True when this call retired the entry."""
    _, swapped = store.compare_set(f"{_EXPO_PREFIX}/ep/{name}",
                                   str(address), "")
    if swapped:
        metrics.cas_index(store, f"{_EXPO_PREFIX}/eps", name, add=False,
                          attempts=attempts, what="expo retire")
    return swapped


def endpoints(store):
    """{name: "host:port"} of every announced live endpoint."""
    try:
        raw = store.get(f"{_EXPO_PREFIX}/eps").decode()
    except KeyError:
        return {}
    out = {}
    for name in sorted(n for n in raw.split(",") if n):
        try:
            addr = store.get(f"{_EXPO_PREFIX}/ep/{name}").decode()
        except KeyError:
            continue
        if addr:
            out[name] = addr
    return out
