"""Metrics registry: labeled counters/gauges/histograms with a
store-backed fleet publish (a copy of
``paddle_tpu/observability/metrics.py``).

In-process recording is a dict lookup + float update under a lock —
cheap enough to stay unconditional on control-plane paths (store ops,
collective byte accounting). The fleet dimension rides the EXISTING
membership plane: ``publish(store, rank)`` serializes this process's
snapshot into the TCPStore/ReplicatedStore the elastic stack already
shares, and ``fleet_snapshot(store)`` folds every published rank into
one aggregate (counters/histograms sum; gauges keep per-rank values) —
the agent can dump a whole-fleet view without any new transport.

Pure stdlib and standalone-importable (same constraint as trace.py):
the store argument is duck-typed (set/get/compare_set), never imported.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref

# histogram default bounds: latency-shaped (ms), 100µs .. ~2min
DEFAULT_BUCKETS = (0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0,
                   1000.0, 5000.0, 30000.0, 120000.0)

_PUBLISH_PREFIX = "__metrics"

# per-connection memo of ranks known to be in the publish index: the
# index is append-only between unpublishes, so re-verifying membership
# (a store get) on EVERY periodic publish is a wasted round-trip per
# beat per publisher at fleet scale. Keyed
# weakly by the store HANDLE — a reconnected/fresh store starts cold,
# while a ReplicatedStore object riding a failover keeps its memo (the
# index key is mirrored to the standby with the rest of the kv).
_INDEXED = weakref.WeakKeyDictionary()


def _label_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def percentile(vals, q):
    """Exact order-statistic percentile (nearest rank) of a raw value
    list — THE shared home for percentile math.
    Returns None on an empty list."""
    if not vals:
        return None
    vals = sorted(vals)
    k = min(int(round(q * (len(vals) - 1))), len(vals) - 1)
    return vals[k]


def hist_quantile(bounds, bucket_counts, p):
    """Prometheus-style histogram quantile off bucket counts (one count
    per bucket, NOT cumulative; the trailing count is the +Inf bucket).
    Linear interpolation inside the landing bucket; a quantile landing
    in +Inf returns the highest finite bound (the histogram cannot say
    more). Returns None when the histogram is empty."""
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


_SNAPSHOT_QUANTILES = (0.5, 0.9, 0.99)


def cas_index(store, key, member, add=True, attempts=64, what="index"):
    """Add/remove ``member`` in a comma-joined membership-set key via
    compare_set — THE shared home of the CAS-index loop (publish
    ranks, perf ranks, expo endpoints all ride it): concurrent first
    writers never drop each other, and the retry/raise policy lives in
    one place."""
    member = str(member)
    for _ in range(attempts):
        try:
            cur = store.get(key).decode()
        except KeyError:
            if not add:
                return
            cur = ""
        members = {m for m in cur.split(",") if m}
        if (member in members) == add:
            return
        new = ",".join(sorted(members | {member} if add
                              else members - {member}))
        _, swapped = store.compare_set(key, cur, new)
        if swapped:
            return
    raise RuntimeError(
        f"{what}: membership CAS lost {attempts} straight races "
        "(store misbehaving?)")


class Metric:
    """Base: one named metric holding labeled series."""

    kind = "metric"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._series = {}
        self._lock = threading.Lock()

    def series(self):
        """{labels_dict_as_tuple: value} snapshot (histograms: state
        dict). Use ``samples()`` for the friendly list form."""
        with self._lock:
            return dict(self._series)

    def samples(self):
        """[(labels_dict, value_or_state), ...] sorted by labels."""
        return [(dict(k), v) for k, v in sorted(self.series().items())]

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

    def value(self, **labels):
        return self._series.get(_label_key(labels), 0)

    def total(self):
        """Sum over every labeled series (the aggregate view legacy
        counters like _P2PChannel.bytes_sent expose)."""
        with self._lock:
            return sum(self._series.values())


class Gauge(Metric):
    kind = "gauge"

    def set(self, value, **labels):
        with self._lock:
            self._series[_label_key(labels)] = value

    def inc(self, value=1, **labels):
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0) + value

    def dec(self, value=1, **labels):
        self.inc(-value, **labels)

    def value(self, **labels):
        return self._series.get(_label_key(labels))


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
                st["buckets"][-1] += 1  # +Inf bucket

    def time(self, **labels):
        """Context manager observing the elapsed milliseconds."""
        return _HistTimer(self, labels)

    def quantile(self, p, **labels):
        """Native quantile over one labeled series:
        Prometheus-style interpolation inside the landing bucket, the
        highest finite bound for a +Inf landing, None when empty."""
        st = self._series.get(_label_key(labels))
        if st is None:
            return None
        return hist_quantile(self.buckets, st["buckets"], p)

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


class _HistTimer:
    __slots__ = ("_hist", "_labels", "_t0")

    def __init__(self, hist, labels):
        self._hist = hist
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe((time.perf_counter() - self._t0) * 1e3,
                           **self._labels)
        return False


class Registry:
    """Named metrics, get-or-create per name (re-registration with a
    different kind is a bug and raises)."""

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

    def get(self, name):
        return self._metrics.get(name)

    def clear(self):
        """Reset every metric's series to empty, keeping the metric
        OBJECTS registered — instrumented modules hold references to
        them at import, so dropping the objects would silently fork the
        accounting. Aggregate views (e.g. `_P2PChannel.bytes_sent`)
        reset with it."""
        with self._lock:
            for m in self._metrics.values():
                with m._lock:
                    m._series = {}

    def snapshot(self):
        """One JSON-serializable dict of every metric's every series."""
        return {"pid": os.getpid(), "ts_ns": time.time_ns(),
                "metrics": {name: m.snapshot()
                            for name, m in sorted(self._metrics.items())}}

    # -- fleet publish over the membership store -----------------------------
    def publish(self, store, rank):
        """Publish this process's snapshot under ``rank`` through the
        shared membership store. Last-writer-wins per rank (publish is
        periodic/at-teardown, not a log). The rank index key is
        maintained with a CAS append so concurrent first publishes from
        different ranks never drop each other."""
        payload = json.dumps(self.snapshot(), default=str)
        store.set(f"{_PUBLISH_PREFIX}/r{rank}", payload)
        try:
            seen = _INDEXED.setdefault(store, set())
        except TypeError:        # un-weakref-able store stub: no memo
            seen = None
        if seen is None or str(rank) not in seen:
            self._index_add(store, rank)
            if seen is not None:
                seen.add(str(rank))
        return len(payload)

    @staticmethod
    def _index_add(store, rank, attempts=64):
        cas_index(store, f"{_PUBLISH_PREFIX}/ranks", rank,
                  attempts=attempts, what="metrics publish rank index")

    @staticmethod
    def published_ranks(store):
        """Publisher ids, as strings (trainer ranks publish as "0"...;
        agents as "agent0"... — the id is a label, not an index)."""
        try:
            raw = store.get(f"{_PUBLISH_PREFIX}/ranks").decode()
        except KeyError:
            return []
        return sorted(r for r in raw.split(",") if r)

    @staticmethod
    def unpublish(store, rank, attempts=64):
        """Retire a publisher (graceful departure — a drained serving
        replica, a scaled-in agent): the rank leaves the index and its
        snapshot key is emptied, so `fleet_snapshot` forgets it even
        though a deregistered rank never shows up in `dead_ranks`
       ."""
        store.set(f"{_PUBLISH_PREFIX}/r{rank}", "")
        cas_index(store, f"{_PUBLISH_PREFIX}/ranks", rank, add=False,
                  attempts=attempts, what="metrics unpublish rank index")
        try:
            seen = _INDEXED.get(store)
        except TypeError:
            seen = None
        if seen is not None:
            seen.discard(str(rank))

    @classmethod
    def fleet_snapshot(cls, store, live_timeout=None):
        """Collect every published rank's snapshot and aggregate:
        counters and histograms SUM across ranks; gauges keep one series
        per (rank, labels) — a per-rank fact stays per-rank.

        ``live_timeout`` (seconds) scopes the view to LIVE publishers
        via the store's heartbeat liveness table: a
        numeric rank reported by ``store.dead_ranks(live_timeout)`` is
        dropped entirely, so a SIGKILLed replica's occupancy gauge
        cannot linger in the fleet view forever. Non-numeric publisher
        ids (e.g. "agent0") have no heartbeat rank and are never scoped
        out. Without ``live_timeout`` the aggregate keeps every
        publisher — the teardown/post-mortem view."""
        dead = set()
        if live_timeout is not None:
            dead = {str(r) for r in store.dead_ranks(live_timeout)}
        snaps = {}
        for rank in cls.published_ranks(store):
            if rank in dead:
                continue
            try:
                raw = store.get(f"{_PUBLISH_PREFIX}/r{rank}").decode()
                if not raw:
                    continue       # unpublished (graceful departure)
                snaps[rank] = json.loads(raw)
            except (KeyError, ValueError):
                continue  # raced a republish/retire; skip
        return {"ranks": sorted(snaps), "metrics": merge_snapshots(snaps)}


def merge_snapshots(snaps_by_rank):
    """Pure aggregation of ``{rank: snapshot_dict}`` (unit-testable
    without a store): counters/histogram series sum per (name, labels);
    gauges gain a ``rank`` label and stay distinct."""
    out = {}
    for rank, snap in sorted(snaps_by_rank.items()):
        for name, m in snap.get("metrics", {}).items():
            agg = out.setdefault(name, {"kind": m["kind"],
                                        "help": m.get("help", ""),
                                        "series": {}})
            if "bounds" in m:
                agg["bounds"] = m["bounds"]
            for s in m["series"]:
                labels = dict(s["labels"])
                if m["kind"] == "gauge":
                    labels["rank"] = str(rank)
                key = _label_key(labels)
                cur = agg["series"].get(key)
                if m["kind"] == "histogram":
                    if cur is None:
                        agg["series"][key] = {
                            "labels": labels, "count": s["count"],
                            "sum": s["sum"],
                            "buckets": list(s["buckets"])}
                    else:
                        cur["count"] += s["count"]
                        cur["sum"] += s["sum"]
                        cur["buckets"] = [a + b for a, b in
                                          zip(cur["buckets"], s["buckets"])]
                else:
                    if cur is None:
                        agg["series"][key] = {"labels": labels,
                                              "value": s["value"]}
                    elif m["kind"] == "counter":
                        cur["value"] += s["value"]
                    else:  # gauge: rank label makes keys unique
                        cur["value"] = s["value"]
    for agg in out.values():
        agg["series"] = [agg["series"][k] for k in sorted(agg["series"])]
        if agg["kind"] == "histogram" and "bounds" in agg:
            for s in agg["series"]:   # recompute over the SUMMED buckets
                s["quantiles"] = {
                    f"p{int(q * 100)}": hist_quantile(
                        agg["bounds"], s["buckets"], q)
                    for q in _SNAPSHOT_QUANTILES}
    return out


REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
get = REGISTRY.get
snapshot = REGISTRY.snapshot
clear = REGISTRY.clear


def publish(store, rank):
    return REGISTRY.publish(store, rank)


def unpublish(store, rank):
    return Registry.unpublish(store, rank)


def fleet_snapshot(store, live_timeout=None):
    return Registry.fleet_snapshot(store, live_timeout=live_timeout)


def published_ranks(store):
    return Registry.published_ranks(store)
