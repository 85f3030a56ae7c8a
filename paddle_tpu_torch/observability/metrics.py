"""Metrics registry: labeled counters, gauges and histograms (a trimmed
copy of ``paddle_tpu/observability/metrics.py``: the store-backed fleet
publish is not part of this slice).

Recording is a dict lookup and a float update under a lock, cheap enough
to stay unconditional on the serving engine's step path.
"""
from __future__ import annotations

import os
import threading
import time

# histogram default bounds: latency-shaped (ms), 100 us .. ~2 min
DEFAULT_BUCKETS = (0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0,
                   1000.0, 5000.0, 30000.0, 120000.0)
_SNAPSHOT_QUANTILES = (0.5, 0.9, 0.99)


def _label_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def percentile(vals, q):
    """Exact order-statistic percentile (nearest rank) of a raw value
    list. Returns None on an empty list."""
    if not vals:
        return None
    vals = sorted(vals)
    k = min(int(round(q * (len(vals) - 1))), len(vals) - 1)
    return vals[k]


def hist_quantile(bounds, bucket_counts, p):
    """Prometheus-style quantile off per-bucket counts (the trailing
    count is the +Inf bucket), interpolating inside the landing bucket.
    None when the histogram is empty."""
    total = sum(bucket_counts)
    if total <= 0:
        return None
    target = p * total
    cum = 0.0
    lo = 0.0
    for i, ub in enumerate(bounds):
        prev = cum
        cum += bucket_counts[i]
        if cum >= target:
            frac = (target - prev) / max(bucket_counts[i], 1)
            return lo + (ub - lo) * min(max(frac, 0.0), 1.0)
        lo = ub
    return bounds[-1] if bounds else None


class Metric:
    """Base: one named metric holding labeled series."""

    kind = "metric"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._series = {}
        self._lock = threading.Lock()

    def series(self):
        with self._lock:
            return dict(self._series)

    def _snap_series(self):
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self.series().items())]

    def snapshot(self):
        return {"kind": self.kind, "help": self.help,
                "series": self._snap_series()}


class Counter(Metric):
    kind = "counter"

    def inc(self, value=1, **labels):
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0) + value

    def total(self):
        with self._lock:
            return sum(self._series.values())


class Gauge(Metric):
    kind = "gauge"

    def set(self, value, **labels):
        with self._lock:
            self._series[_label_key(labels)] = value


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, help="", buckets=None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))

    def observe(self, value, **labels):
        k = _label_key(labels)
        with self._lock:
            st = self._series.get(k)
            if st is None:
                st = self._series[k] = {
                    "count": 0, "sum": 0.0,
                    "buckets": [0] * (len(self.buckets) + 1)}
            st["count"] += 1
            st["sum"] += float(value)
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    st["buckets"][i] += 1
                    break
            else:
                st["buckets"][-1] += 1

    def _snap_series(self):
        out = []
        for k, st in sorted(self.series().items()):
            qs = {f"p{int(q * 100)}": hist_quantile(self.buckets,
                                                    st["buckets"], q)
                  for q in _SNAPSHOT_QUANTILES}
            out.append({"labels": dict(k), "count": st["count"],
                        "sum": st["sum"], "buckets": list(st["buckets"]),
                        "quantiles": qs})
        return out

    def snapshot(self):
        d = super().snapshot()
        d["bounds"] = list(self.buckets)
        return d


class Registry:
    """Named metrics, get-or-create per name (re-registration under a
    different kind raises)."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help=help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=None):
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def snapshot(self):
        """One JSON-serializable dict of every metric's every series."""
        return {"pid": os.getpid(), "ts_ns": time.time_ns(),
                "metrics": {name: m.snapshot()
                            for name, m in sorted(self._metrics.items())}}


REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
