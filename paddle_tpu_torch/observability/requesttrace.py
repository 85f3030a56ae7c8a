"""Request-scoped distributed tracing for the serving plane (a copy of
``paddle_tpu/observability/requesttrace.py``).

The fleet's spans were process-scoped: a request's real story — submit
at the router, route, mailbox wait, admit, prefill, per-tick decode,
a possible failover detection + re-route, commit — crosses at least
two processes and, under failover, three. This module makes ONE
request reconstructible from the merged trace:

- **Request ids on every hop**: the router's fleet ``rid`` rides the
  request payload and is threaded onto every serving span/event
  (``serve.submit``/``serve.route``/``req.admit``/``serve.prefill``
  with ``rid=``, ``serve.decode_step`` with the batch's ``rids=`` list,
  ``req.evict``/``req.finish``/``req.done`` lifecycle events) — ids
  are stable across replicas, so a re-routed request keeps one
  identity end to end.

- **Cross-process clock anchoring** (the shared home of the
  router-clock→replica-clock submit-stamp mapping the fleet benchmark
  and ``EngineHarness.admit`` previously each hand-rolled): every
  process's export already stamps wall-clock µs, which is exact on one
  host and SKEWED across hosts. ``anchor_offsets`` bounds each shard's
  offset against the router's clock with the classic two-sided
  one-way-delay argument — a stamp created in clock A and observed in
  clock B can only be observed AFTER it was created:

      forward  (router stamp  → replica event):  d ≤ min(ts_obs − stamp)
      reverse  (replica stamp → router event):   d ≥ max(stamp − ts_obs)

  where ``d`` is the shard's offset ahead of the router. An interval
  containing 0 means the clocks are consistent (same host) and the
  shard is left UNTOUCHED — the pass only corrects provable skew, by
  the nearest interval endpoint (the residual error is bounded by the
  minimum observed one-way delay). ``merge_traces`` here = the plain
  ``trace.merge_traces`` + this anchor pass; the applied per-pid
  shifts are recorded under ``clockOffsets`` in the merged dict.

- **``request_timeline(trace, rid)``**: one request's full phase
  breakdown off the merged events — queue, route, dispatch (mailbox),
  prefill, per-tick decode, and on failover the detection + re-route
  phases — plus a ``--request`` CLI that renders it.

Pure stdlib, standalone-importable (same constraint as trace.py);
instrumented modules import only ``trace`` — this module is the
read/merge side.
"""
from __future__ import annotations

import json
import time

from . import trace

# events/attrs this module interprets (the span/field map is documented
# in docs/OBSERVABILITY.md):
#   serve.submit   event  rid, origin_unix_us   (router; origin stamp)
#   serve.route    span   rid, replica, requeue (router)
#   req.admit      event  rid, origin_unix_us   (replica; forward anchor)
#   serve.prefill  span   rid, tokens, cached_tokens (replica)
#   serve.decode_step span rids=[...]           (replica; one tick each)
#   req.evict      event  rid                   (replica)
#   req.finish     event  rid, status, tokens   (replica)
#   req.done       event  rid, replica, done_unix_us (router; reverse
#                                                     anchor)
#   serve.replica_death event replica           (router; detection)


def arrival_from_origin(t_origin_unix, now_unix=None, now_perf=None):
    """Map an origin-domain wall-clock submit stamp onto THIS process's
    perf_counter timeline (the same-host mapping TTFT accounting uses:
    queueing + detection + re-route delay all count). Factored here so
    the serve path and the benchmarks share one definition."""
    if now_unix is None:
        now_unix = time.time()
    if now_perf is None:
        now_perf = time.perf_counter()
    return now_perf - max(now_unix - float(t_origin_unix), 0.0)


# -- the clock-anchor pass ----------------------------------------------------

def _rid_of(e):
    rid = e.get("args", {}).get("rid")
    return None if rid is None else str(rid)


def anchor_offsets(events):
    """Per-pid clock offsets (µs, positive = that shard's clock runs
    AHEAD of the router's) estimated from the origin stamps embedded in
    the request flow. Returns {} when there is no router shard or no
    stamped events to anchor on."""
    routers = {e["pid"] for e in events if e.get("name") == "serve.submit"}
    if not routers:
        return {}
    ref = min(routers)
    # forward: replica-side req.admit events carry the router's
    # origin_unix_us stamp — observation can't precede creation
    hi = {}
    for e in events:
        if e.get("name") != "req.admit" or e["pid"] == ref:
            continue
        stamp = e.get("args", {}).get("origin_unix_us")
        if stamp is None:
            continue
        s = e["ts"] - float(stamp)
        pid = e["pid"]
        hi[pid] = s if pid not in hi else min(hi[pid], s)
    # reverse: router-side req.done events carry the REPLICA's
    # done_unix_us stamp; map it to the creating pid via replica.join
    rep_pid = {}
    for e in events:
        if e.get("name") == "replica.join":
            a = e.get("args", {})
            if "replica" in a:
                rep_pid[str(a["replica"])] = a.get("pid", e["pid"])
    lo = {}
    for e in events:
        if e.get("name") != "req.done" or e["pid"] != ref:
            continue
        a = e.get("args", {})
        stamp = a.get("done_unix_us")
        pid = rep_pid.get(str(a.get("replica")))
        if stamp is None or pid is None or pid == ref:
            continue
        s = float(stamp) - e["ts"]
        lo[pid] = s if pid not in lo else max(lo[pid], s)
    offsets = {}
    for pid in set(hi) | set(lo):
        l = lo.get(pid, float("-inf"))
        h = hi.get(pid, float("inf"))
        if l > h:           # contradictory samples (torn shard): the
            l, h = h, l     # swapped pair still bounds the offset
        if l <= 0.0 <= h:
            offsets[pid] = 0.0      # consistent clocks: never touch
        elif pid in lo:
            # the reverse bound is the TIGHT one: its slack is one
            # harvest poll, while the forward bound's slack includes
            # genuine queueing (mailbox wait, detection windows)
            offsets[pid] = l
        else:
            # forward-only evidence: h < 0 proves the clock is behind
            # by at least -h; h > 0 proves nothing (l = -inf)
            offsets[pid] = h if h < 0.0 else 0.0
    return {p: o for p, o in offsets.items() if o != 0.0}


def apply_anchor(events, offsets):
    """Shift every event of an offset pid onto the router's timebase
    (in place). Returns the events list."""
    if offsets:
        for e in events:
            off = offsets.get(e.get("pid"))
            if off:
                e["ts"] = e["ts"] - off
    return events


def merge_traces(trace_dir, extra_events=()):
    """``trace.merge_traces`` + the clock-anchor pass: every shard of a
    serving-fleet run lands on the ROUTER's timebase, with the applied
    per-pid shifts recorded under ``clockOffsets``."""
    merged = trace.merge_traces(trace_dir, extra_events=extra_events)
    events = merged["traceEvents"]
    offsets = anchor_offsets(events)
    apply_anchor(events, offsets)
    if offsets:
        events.sort(key=lambda e: e.get("ts", 0.0))
        merged["clockOffsets"] = {str(p): round(o, 3)
                                  for p, o in offsets.items()}
    return merged


# -- request timeline ---------------------------------------------------------

def _events_of(trace_or_events):
    if isinstance(trace_or_events, dict):
        return trace_or_events.get("traceEvents", [])
    return list(trace_or_events)


def request_ids(trace_or_events):
    """Every rid the trace knows about, sorted numerically when
    possible."""
    rids = {_rid_of(e) for e in _events_of(trace_or_events)}
    rids.discard(None)
    return sorted(rids, key=lambda r: (not r.isdigit(),
                                       int(r) if r.isdigit() else r))


def request_timeline(trace_or_events, request_id):
    """Reconstruct ONE request's phase breakdown from a merged trace.

    Returns a dict: ``rid``, ``found``, ``requeues``, ``replicas`` (in
    assignment order — stable ids across a failover), ``ttft_ms``
    (submit → end of first prefill, the first token), ``total_ms``
    (submit → commit), ``decode_ticks``, and ``phases`` — an ordered
    list of ``{phase, t0_us, dur_ms, ...}`` covering:

    - ``queue``      submit → the routing decision
    - ``route``      each serve.route span (``replica``, ``requeue``)
    - ``dispatch``   route end → the replica admits (mailbox + poll)
    - ``prefill``    the prefill span (``cached_tokens`` marks hits)
    - ``decode``     one aggregate per assignment (``ticks``, with the
                     per-tick spans under ``tick_ms``)
    - ``detection``  last activity on a dead replica → the router's
                     staleness verdict (failover only)
    - ``re-route``   the death verdict → the requeued route (failover
                     only; an ``evicted`` count rides the attrs when
                     the engine evicted it meanwhile)
    - ``commit``     last replica activity → the completion observed
                     at the router
    """
    rid = str(request_id)
    ev = [e for e in _events_of(trace_or_events)]
    mine = [e for e in ev if _rid_of(e) == rid]
    out = {"rid": rid, "found": bool(mine), "phases": [],
           "replicas": [], "requeues": 0, "decode_ticks": 0,
           "ttft_ms": None, "total_ms": None}
    if not mine:
        return out

    def spans(name):
        return trace.spans_named(mine, name)

    def evts(name):
        return trace.events_named(mine, name)

    submit = evts("serve.submit")
    routes = spans("serve.route")
    admits = evts("req.admit")
    prefills = spans("serve.prefill")
    evictions = evts("req.evict")
    finishes = evts("req.finish")
    dones = evts("req.done") + evts("serve.requeued_done")
    deaths = trace.events_named(ev, "serve.replica_death")
    decode_ticks = [s for s in trace.spans_named(ev, "serve.decode_step")
                    if rid in [str(r) for r in
                               s.get("args", {}).get("rids", [])]]
    out["decode_ticks"] = len(decode_ticks)
    out["requeues"] = max([int(s["args"].get("requeue", 0))
                           for s in routes], default=0)
    out["replicas"] = [s["args"].get("replica") for s in routes]

    phases = out["phases"]

    def add(phase, t0, t1, **attrs):
        if t0 is None or t1 is None:
            return
        d = dict(attrs)
        d.update(phase=phase, t0_us=round(t0, 1),
                 dur_ms=round(max(t1 - t0, 0.0) / 1e3, 3))
        phases.append(d)

    t_submit = submit[0]["ts"] if submit else None
    if t_submit is not None and routes:
        add("queue", t_submit, routes[0]["ts"])
    def _deaths_of(rep):
        """Death verdicts for ONE replica — phases must never anchor
        on an unrelated replica's death in a multi-death fleet."""
        return [d["ts"] for d in deaths
                if str(d.get("args", {}).get("replica")) == str(rep)]

    # walk assignments: each route opens a segment on one replica
    for i, r in enumerate(routes):
        rep = r["args"].get("replica")
        seg_t0 = r["ts"]
        seg_t1 = routes[i + 1]["ts"] if i + 1 < len(routes) else None
        if int(r["args"].get("requeue", 0)) > 0 and i > 0:
            # the re-route phase: the PREVIOUS assignment's death
            # verdict → this route's START (the route span itself is
            # its own phase — ending here would double-count it in
            # the TTFT attribution)
            prev_rep = routes[i - 1]["args"].get("replica")
            prev_t0 = routes[i - 1]["ts"]
            verdicts = [t for t in _deaths_of(prev_rep)
                        if t <= seg_t0]
            if verdicts:
                add("re-route", max(verdicts), seg_t0,
                    replica=rep, requeue=int(r["args"]["requeue"]),
                    # evictions of the FAILED assignment only — the
                    # request's earlier hops' churn is theirs
                    evicted=len([x for x in evictions
                                 if prev_t0 <= x["ts"] <= seg_t0]))
        add("route", r["ts"], trace.span_end_us(r), replica=rep,
            requeue=int(r["args"].get("requeue", 0)))

        def in_seg(ts):
            return ts >= seg_t0 and (seg_t1 is None or ts < seg_t1)

        seg_admits = [a for a in admits if in_seg(a["ts"])]
        seg_prefills = [p for p in prefills if in_seg(p["ts"])]
        seg_ticks = [t for t in decode_ticks if in_seg(t["ts"])]
        last_activity = trace.span_end_us(r)
        if seg_admits:
            add("dispatch", trace.span_end_us(r), seg_admits[0]["ts"],
                replica=rep)
            last_activity = seg_admits[0]["ts"]
        for p in seg_prefills:
            add("prefill", p["ts"], trace.span_end_us(p), replica=rep,
                tokens=p["args"].get("tokens"),
                cached_tokens=p["args"].get("cached_tokens"))
            last_activity = trace.span_end_us(p)
        if seg_ticks:
            add("decode", seg_ticks[0]["ts"],
                trace.span_end_us(seg_ticks[-1]), replica=rep,
                ticks=len(seg_ticks),
                tick_ms=[round(t.get("dur", 0.0) / 1e3, 3)
                         for t in seg_ticks])
            last_activity = trace.span_end_us(seg_ticks[-1])
        # failover: this segment ends with a re-route → the detection
        # window runs from the last thing the dead replica did for us
        # to the router's verdict
        nxt = routes[i + 1] if i + 1 < len(routes) else None
        if nxt is not None and int(nxt["args"].get("requeue", 0)) > 0:
            verdicts = [t for t in _deaths_of(rep)
                        if last_activity <= t <= nxt["ts"]]
            if verdicts:
                add("detection", last_activity, min(verdicts),
                    replica=rep)
    # commit: the completion as the router observed it
    t_done = min([d["ts"] for d in dones], default=None)
    t_fin = max([f["ts"] for f in finishes], default=None)
    if t_done is not None:
        add("commit", t_fin if t_fin is not None else t_done, t_done)
    # headline numbers. The client-visible first token is the end of
    # the LAST prefill: an evicted or re-routed request re-prefills and
    # only the final binding's tokens commit — earlier prefills' output
    # was discarded with the assignment.
    first_token = max([trace.span_end_us(p) for p in prefills],
                      default=None)
    if t_submit is not None and first_token is not None:
        out["ttft_ms"] = round((first_token - t_submit) / 1e3, 3)
    t_end = t_done if t_done is not None else t_fin
    if t_submit is not None and t_end is not None:
        out["total_ms"] = round((t_end - t_submit) / 1e3, 3)
    out["phase_ms"] = {}
    for p in phases:
        out["phase_ms"][p["phase"]] = round(
            out["phase_ms"].get(p["phase"], 0.0) + p["dur_ms"], 3)
    # TTFT attribution (the serving_slo row's p99 decomposition): each
    # phase clipped to the [submit, first token] window; the residual
    # — mailbox/engine poll gaps no span covers — is named, not hidden
    if t_submit is not None and first_token is not None:
        attr = {}
        for p in phases:
            t0 = p["t0_us"]
            t1 = t0 + p["dur_ms"] * 1e3
            ov = min(t1, first_token) - max(t0, t_submit)
            if ov > 0 and p["phase"] not in ("commit",):
                attr[p["phase"]] = round(
                    attr.get(p["phase"], 0.0) + ov / 1e3, 3)
        covered = sum(attr.values())
        attr["other"] = round(max(out["ttft_ms"] - covered, 0.0), 3)
        out["ttft_attribution_ms"] = attr
        out["ttft_phase_coverage"] = round(
            min(covered / out["ttft_ms"], 1.0), 3) \
            if out["ttft_ms"] else None
    return out


def render_timeline(tl):
    """One request's timeline as human-readable text (the --request
    CLI output)."""
    lines = [f"request {tl['rid']}"
             + ("" if tl["found"] else "  (not found in trace)")]
    if not tl["found"]:
        return "\n".join(lines)
    lines.append(
        f"  replicas={tl['replicas']} requeues={tl['requeues']} "
        f"decode_ticks={tl['decode_ticks']} "
        f"ttft_ms={tl['ttft_ms']} total_ms={tl['total_ms']}")
    t0 = tl["phases"][0]["t0_us"] if tl["phases"] else 0.0
    for p in tl["phases"]:
        extras = {k: v for k, v in p.items()
                  if k not in ("phase", "t0_us", "dur_ms", "tick_ms")}
        off = (p["t0_us"] - t0) / 1e3
        lines.append(f"  +{off:10.3f}ms  {p['phase']:<10} "
                     f"{p['dur_ms']:9.3f}ms  "
                     + " ".join(f"{k}={v}" for k, v in extras.items()))
    lines.append("  phase totals: " + " ".join(
        f"{k}={v}ms" for k, v in sorted(tl["phase_ms"].items())))
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.requesttrace",
        description="Reconstruct one request's phase timeline from a "
                    "merged serving-fleet trace (docs/OBSERVABILITY.md)")
    ap.add_argument("--trace", required=True,
                    help="merged chrome-trace JSON file, or a trace dir "
                         "of per-process shards to anchor-merge")
    ap.add_argument("--request", default=None,
                    help="rid to render (omit with --list)")
    ap.add_argument("--list", action="store_true",
                    help="list the request ids the trace knows")
    ap.add_argument("--json", action="store_true",
                    help="emit the timeline as JSON instead of text")
    args = ap.parse_args(argv)
    import os
    if os.path.isdir(args.trace):
        merged = merge_traces(args.trace)
        events = merged["traceEvents"]
    else:
        events = trace.load_trace(args.trace)
    if args.list or args.request is None:
        for rid in request_ids(events):
            print(rid)
        return 0
    tl = request_timeline(events, args.request)
    print(json.dumps(tl, indent=1) if args.json else render_timeline(tl))
    return 0 if tl["found"] else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
