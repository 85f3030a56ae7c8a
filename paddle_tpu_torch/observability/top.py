"""``python -m paddle_tpu_torch.observability.top``: live fleet telemetry,
the scrape side (counterpart: ``paddle_tpu/observability/top.py``).

Discovers the fleet's ``/metrics`` endpoints through the membership store
(``expo.announce``: replicas announce at attach, the router through
``expo.serve_metrics``), scrapes each process's ``/snapshot.json`` and
renders a table a replica a line: occupancy, free KV pages, TTFT p50/p99
(histogram quantiles), total and per-second token throughput (counter
deltas between refresh ticks), prefix-hit rate, and the router's
routed/requeued/timeout counters when a router endpoint is announced. A
running fleet can be inspected without stopping it.

    python -m paddle_tpu_torch.observability.top --store H:P [--interval S]
    python -m paddle_tpu_torch.observability.top --endpoints a=H:P,b=H:P --once

Stdlib only (urllib, with a timeout on every scrape) but for the store
client, ``distributed/store.TCPStore``.
"""
from __future__ import annotations

import json
import sys
import time
import urllib.request


def scrape(address, timeout=2.0):
    """One endpoint's registry snapshot dict (``/snapshot.json``)."""
    with urllib.request.urlopen(
            f"http://{address}/snapshot.json", timeout=timeout) as r:
        return json.loads(r.read().decode())


def _gauge(snap, name):
    m = snap.get("metrics", {}).get(name)
    if not m or not m.get("series"):
        return None
    return m["series"][-1].get("value")


def _counter_total(snap, name):
    m = snap.get("metrics", {}).get(name)
    if not m:
        return 0
    return sum(s.get("value", 0) for s in m.get("series", []))


def _hist_quantiles(snap, name):
    m = snap.get("metrics", {}).get(name)
    if not m or not m.get("series"):
        return {}
    # aggregate across label series via the summed buckets
    from . import metrics as mx
    bounds = m.get("bounds", [])
    buckets = None
    for s in m["series"]:
        b = s.get("buckets", [])
        buckets = list(b) if buckets is None \
            else [x + y for x, y in zip(buckets, b)]
    if buckets is None:
        return {}
    return {q: mx.hist_quantile(bounds, buckets, q)
            for q in (0.5, 0.99)}


def fleet_rows(snapshots):
    """Per-endpoint derived stats off ``{name: snapshot}``."""
    rows = {}
    for name, snap in sorted(snapshots.items()):
        qs = _hist_quantiles(snap, "serving_ttft_ms")
        lookups = _counter_total(snap, "serving_prefix_lookups")
        rows[name] = {
            "occupancy": _gauge(snap, "serving_batch_occupancy"),
            "free_pages": _gauge(snap, "serving_free_pages"),
            "tokens": _counter_total(snap, "serving_tokens_generated"),
            "ttft_p50_ms": qs.get(0.5),
            "ttft_p99_ms": qs.get(0.99),
            "prefix_hit_rate": (
                _counter_total(snap, "serving_prefix_hits") / lookups
                if lookups else None),
            "routed": _counter_total(snap, "serving_router_routed"),
            "requeued": _counter_total(snap, "serving_router_requeued"),
            "timeouts": _counter_total(snap, "serving_router_timeouts"),
            "replicas": _gauge(snap, "serving_fleet_replicas"),
        }
    return rows


def _f(v, fmt="{:.1f}", none="-"):
    return none if v is None else fmt.format(v)


def render(rows, prev=None, dt=None):
    """The table (one line per endpoint; router counters inline)."""
    out = ["endpoint         occ  free_pg   tok/s     tokens  "
           "ttft_p50  ttft_p99  hit%"]
    for name, r in sorted(rows.items()):
        tps = None
        if prev and name in prev and dt:
            tps = (r["tokens"] - prev[name]["tokens"]) / dt
        line = (f"{name:<15} {_f(r['occupancy'], '{:>4.0f}'):>4} "
                f"{_f(r['free_pages'], '{:>7.0f}'):>8} "
                f"{_f(tps, '{:>7.1f}'):>7} "
                f"{r['tokens']:>10} "
                f"{_f(r['ttft_p50_ms'], '{:>8.1f}'):>9} "
                f"{_f(r['ttft_p99_ms'], '{:>8.1f}'):>9} "
                f"{_f(r['prefix_hit_rate'], '{:>4.0%}'):>5}")
        if r["routed"]:
            line += (f"  [router: routed={r['routed']} "
                     f"requeued={r['requeued']} "
                     f"timeouts={r['timeouts']} "
                     f"replicas={_f(r['replicas'], '{:.0f}')}]")
        out.append(line)
    return "\n".join(out)


class _Discovery:
    """Endpoint discovery holding ONE store client across refresh
    ticks (a monitor must not connect-churn the fleet's control
    plane); the client is re-created only after a failure."""

    def __init__(self, args):
        self._static = None
        if args.endpoints:
            self._static = {}
            for item in args.endpoints.split(","):
                name, _, addr = item.partition("=")
                self._static[name or addr] = addr or name
        self._master = args.store
        self._store = None

    def _client(self):
        if self._store is None:
            from ..distributed.store import TCPStore
            host, _, port = self._master.rpartition(":")
            self._store = TCPStore(host=host or "127.0.0.1",
                                   port=int(port), world_size=1,
                                   timeout=10.0)
        return self._store

    def endpoints(self):
        if self._static is not None:
            return self._static
        from . import expo
        try:
            return expo.endpoints(self._client())
        except (RuntimeError, OSError):
            # store hiccup: drop the client, retry next tick
            self.close()
            raise
        except KeyError:
            return {}

    def close(self):
        if self._store is not None:
            try:
                self._store.close()
            # teardown of an already failed connection: nothing to do
            except Exception:
                pass
            self._store = None


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.top",
        description="live serving-fleet telemetry over store-discovered"
                    " /metrics endpoints")
    ap.add_argument("--store", default=None,
                    help="membership store H:P (endpoint discovery)")
    ap.add_argument("--endpoints", default=None,
                    help="bypass discovery: name=H:P[,name=H:P...]")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="print one table and exit")
    ap.add_argument("-n", type=int, default=0,
                    help="number of refresh ticks (0 = until Ctrl-C)")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-endpoint scrape deadline (seconds)")
    args = ap.parse_args(argv)
    if not args.store and not args.endpoints:
        ap.error("one of --store / --endpoints is required")

    disco = _Discovery(args)
    prev, prev_t = None, None
    tick = 0
    try:
        while True:
            try:
                eps = disco.endpoints()
            except (RuntimeError, OSError) as e:
                print(f"# store unreachable: {e}", file=sys.stderr)
                eps = {}
            snaps = {}
            for name, addr in eps.items():
                try:
                    snaps[name] = scrape(addr, timeout=args.timeout)
                except OSError as e:     # a dying replica mid-scrape is
                    print(f"# {name} ({addr}): unreachable: {e}",
                          file=sys.stderr)  # normal churn, not fatal
            now = time.monotonic()
            rows = fleet_rows(snaps)
            dt = (now - prev_t) if prev_t is not None else None
            print(time.strftime("-- %H:%M:%S ")
                  + f"({len(snaps)}/{len(eps)} endpoints)")
            print(render(rows, prev=prev, dt=dt), flush=True)
            prev, prev_t = rows, now
            tick += 1
            if args.once or (args.n and tick >= args.n):
                return 0
            time.sleep(args.interval)
    finally:
        disco.close()


if __name__ == "__main__":
    sys.exit(main())
