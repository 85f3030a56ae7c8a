"""Serving replica: a ServingEngine registered in the fleet membership
store (counterpart: ``paddle_tpu/inference/serving/replica.py``).

One replica process = one engine + one store connection. ``attach()``
joins the fleet exactly the way the elastic agent joins a job — a
store-allocated stable id, the LIVENESS RECORD FIRST (the paddlecheck
corpse-before-first-heartbeat lesson: a replica killed between
registration and its first heartbeat must never be an undetectable
corpse), then the info/state keys the router discovers. ``run()`` is
the serve loop: heartbeat, pull routed requests from the replica's
mailbox, step the engine, commit completions (exactly-once via the
``done`` CAS), publish the occupancy gauge the router load-balances by.

Drain protocol (the part the model checker proves):

- the replica ADMITS work only while its state key is ``serving`` AND
  its registered generation is current — a draining or fenced replica
  bounces nothing and computes nothing new; it just stops pulling;
- on ``draining`` (router scale-in, SIGTERM, or a model roll — a new
  generation publishing a DIFFERENT bundle digest) it finishes its
  in-flight requests, posts its pull cursor under ``r{i}/drained`` so
  the router can re-route the never-admitted mailbox tail, deregisters
  its liveness and exits 0;
- a membership-only generation bump (another replica died or drained)
  is NOT a drain: the survivor re-registers at the new generation and
  keeps serving — serving worlds churn members without restarting the
  world, unlike a training job.

Model bundles: ``save_bundle``/``load_bundle`` serialize a GPT model as
``config.json`` + ``params.npz`` with sha256 sidecars; the load path is
gated by the checkpoint digest machinery (``elastic.verify_checkpoint``) AND
by the per-generation published digest (``fleet.publish_bundle``) — a
replica whose bundle hash disagrees with the generation's published
sha256 refuses to serve (exit 5), which is what makes a model-version
roll safe: bump the generation with a new bundle and the old replicas
drain out while new ones gate-load the new weights.

Bundles are the reference's format: the same ``config.json`` keys, the
same parameter names in ``params.npz`` and the same ``.sha256`` sidecars,
so a bundle saved by either package loads in the other (the port loads
through ``convert.load_jax_gpt``).

CLI:

    python -m paddle_tpu_torch.inference.serving.replica \
        --store H:P [--bundle DIR] [--device cuda|cpu] [--poll S]
        [--hb-interval S] [--name NAME]

The device defaults to ``cuda``; ``--device cpu`` exists for the tests.
On the card the kernels are built before the replica attaches (an
``nvcc`` build inside the serve loop would starve its heartbeats into a
false death verdict), and with ``PADDLE_SERVE_COMPILE_CACHE`` set the
engine captures its decode and verify graphs at init, before it
attaches. Prints ``REPLICA_ID=<i>`` once attached; SIGTERM initiates a
graceful drain. Exit codes: 0 drained/stopped, 2 no bundle, 4 store lost,
5 bundle digest refused.
"""
from __future__ import annotations

import json
import os
import sys
import time

import threading

from ...distributed.substrate import NATIVE_SUBSTRATE
from ...observability import metrics, requesttrace, trace
from . import fleet
from .scheduler import (FINISHED, OVERLOADED, EngineOverloaded, Request,
                        RequestTimeout, RequestTooLarge)


class BundleDigestError(RuntimeError):
    """The model bundle fails its recorded or published sha256 — the
    load is refused (serving corrupt or mismatched weights to live
    traffic is strictly worse than not serving)."""


# -- model bundles ------------------------------------------------------------

def save_bundle(model, path):
    """Serialize ``model`` (a GPT family Layer) into ``path``:
    config.json + params.npz, each with a ``.sha256`` sidecar so
    ``elastic.verify_checkpoint`` gates the load. Returns the bundle
    digest (the params.npz sha256) — what ``fleet.publish_bundle``
    publishes per generation."""
    import hashlib

    import numpy as np
    os.makedirs(path, exist_ok=True)
    cfg = model.config
    cfg_dict = {k: getattr(cfg, k) for k in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "intermediate_size", "max_seq_len", "dropout", "use_rmsnorm",
        "tie_word_embeddings")}
    state = {k: v.detach().cpu().numpy()
             for k, v in model.state_dict().items()}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=1, sort_keys=True)
    np.savez(os.path.join(path, "params.npz"), **state)
    digest = None
    for name in ("config.json", "params.npz"):
        h = hashlib.sha256()
        with open(os.path.join(path, name), "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        with open(os.path.join(path, name + ".sha256"), "w") as f:
            f.write(h.hexdigest())
        if name == "params.npz":
            digest = h.hexdigest()
    return digest


def load_bundle(path, expected_sha=None, device=None):
    """Load a bundle into a fresh model, digest-gated twice: the
    recorded sidecars must verify (torn/bit-flipped files), and when
    ``expected_sha`` is given (the generation's PUBLISHED digest) the
    params digest must match it (version mismatch). ``device`` follows
    the port's rule (``"cuda"`` unless ``device="cpu"``). Returns
    (model, digest). Raises BundleDigestError on either refusal."""
    from ...distributed.elastic import verify_checkpoint
    ok, reason = verify_checkpoint(path)
    if not ok:
        raise BundleDigestError(f"bundle {path} refused: {reason}")
    with open(os.path.join(path, "params.npz.sha256")) as f:
        digest = f.read().strip()
    if expected_sha is not None and digest != expected_sha:
        raise BundleDigestError(
            f"bundle {path} digest {digest[:12]}… does not match the "
            f"generation's published sha256 {str(expected_sha)[:12]}… — "
            "refusing to serve mismatched weights")
    import numpy as np

    from ...convert import load_jax_gpt
    from ...text.gpt import GPTConfig, GPTForPretraining
    with open(os.path.join(path, "config.json")) as f:
        cfg = GPTConfig(**json.load(f))
    model = GPTForPretraining(cfg, device=device)
    with np.load(os.path.join(path, "params.npz")) as data:
        load_jax_gpt(model, {k: data[k] for k in data.files})
    model.eval()
    return model, digest


# -- engine adapter -----------------------------------------------------------

class EngineHarness:
    """Adapts a ``ServingEngine`` to the replica serve loop: admit by
    fleet rid, step, harvest typed completions. The model checker
    substitutes a pure stub with this same surface, so the replica's
    protocol code is identical under exploration."""

    def __init__(self, engine):
        self.engine = engine
        self._rids = {}            # Request (identity) -> rid
        self._done_idx = 0

    def admit(self, rid, payload):
        # map the router's wall-clock submit stamp onto this process's
        # perf_counter timeline (shared helper — the trace-merge anchor
        # pass interprets the same stamp) so TTFT counts queueing,
        # detection and re-route delay — not just engine-local time
        arrival = None
        t_sub = payload.get("t_submit_unix")
        if t_sub is not None:
            arrival = requesttrace.arrival_from_origin(t_sub)
        req = Request(payload["prompt"],
                      max_new_tokens=payload.get("max_new_tokens", 16),
                      eos_token_id=payload.get("eos_token_id"),
                      deadline_s=payload.get("deadline_s"),
                      arrival_t=arrival,
                      temperature=payload.get("temperature", 0.0),
                      top_k=payload.get("top_k", 0),
                      top_p=payload.get("top_p", 1.0),
                      seed=payload.get("seed", 0),
                      priority=payload.get("priority", 0))
        req.rid = str(rid)         # ONE id across router/replica spans
        # fast-fail a deadline that burned IN THE MAILBOX: the route→pull gap
        # is real queueing — admitting
        # an already-dead request would waste a prefill before the
        # engine's expire sweep caught it
        if req.expired():
            raise RequestTimeout(
                f"deadline burned before admission (rid {rid})")
        self.engine.submit(req)    # may raise RequestTooLarge /
        # EngineOverloaded — both post typed completions in _pull
        # req.admit means ACCEPTED (a RequestTooLarge refusal above
        # must not leave an admit event in the request's timeline);
        # the origin stamp is the forward anchor sample
        # (requesttrace.anchor_offsets reads it)
        if t_sub is not None:
            trace.event("req.admit", rid=rid,
                        origin_unix_us=t_sub * 1e6)
        else:
            trace.event("req.admit", rid=rid)
        self._rids[req] = rid

    def step(self):
        """One engine iteration; returns [(rid, result_dict), ...] for
        requests that completed (ok or typed timeout)."""
        if self.engine.has_work():
            self.engine.step()
        out = []
        fin = self.engine.scheduler.finished
        while self._done_idx < len(fin):
            req = fin[self._done_idx]
            self._done_idx += 1
            rid = self._rids.pop(req, None)
            if rid is None:
                continue           # a locally-submitted request
            status = fleet.ST_OK if req.state == FINISHED \
                else (fleet.ST_OVERLOADED if req.state == OVERLOADED
                      else fleet.ST_TIMEOUT)
            res = {"status": status,
                   "tokens": list(req.output_tokens),
                   # the reverse anchor sample: a stamp in THIS clock's
                   # wall domain, observed by the router at harvest
                   "t_done_unix": time.time()}
            if status == fleet.ST_OVERLOADED:
                # shed victims carry the retry hint the admission-path
                # refusals do: back off roughly one engine refill
                res["retry_after_s"] = 0.25
            if req.ttft_s is not None:
                res["ttft_ms"] = round(req.ttft_s * 1e3, 3)
            out.append((rid, res))
        return out

    @property
    def busy(self):
        return self.engine.has_work()

    def occupancy(self):
        occ = {"free_pages": self.engine.cache.free_page_count,
               "running": self.engine.scheduler.occupancy,
               "waiting": len(self.engine.scheduler.waiting)}
        # prefix-affinity digest: a bounded list of resident
        # chain heads — the prefix cache's sha256 hash chain keys, so the
        # router's recomputation is bit-identical by construction. The
        # page size rides along because the chain is keyed per page.
        heads = self.engine.prefix_cache.chain_heads(
            limit=int(os.environ.get("PADDLE_SERVE_AFFINITY_KEYS", 32)))
        if heads:
            occ["affinity"] = heads
            occ["page_size"] = self.engine.page_size
        return occ


class ServingReplica:
    """One fleet member: attach, serve, drain (see module docstring).

    ``store`` is any TCPStore-compatible handle (a real client, a
    ReplicatedStore, or paddlecheck's SimHandle); ``harness`` is an
    EngineHarness (or the checker's stub). All waiting goes through the
    injectable ``substrate``/clock so the serve loop is explorable in
    virtual time."""

    def __init__(self, store, harness, name=None, poll=0.05,
                 hb_interval=1.0, substrate=None, stop=None, slo=None,
                 degrade=None):
        self._substrate = substrate if substrate is not None \
            else NATIVE_SUBSTRATE
        self._clock = self._substrate.clock
        self.store = store
        self.harness = harness
        self.name = name
        self.poll = float(poll)
        self.hb_interval = float(hb_interval)
        self.stop = stop               # threading.Event | None
        self.slo = slo                 # observability.slo.SLOEngine | None
        self.degrade = degrade         # serving.degrade controller | None
        self._flag_up = False          # cached fleet burn-flag verdict
        self._flag_check_at = 0.0      # next flag read (hb cadence)
        self._metrics_pub_at = 0.0     # next registry publish (monotonic)
        self._occ_last = None          # last occ payload written
        self._occ_pub_at = 0.0         # next forced occ refresh (monotonic)
        self._expo = None              # observability.expo.MetricsServer
        self.replica_id = None
        self.generation = None
        self.bundle_sha = None
        self.pulled = 0
        self.steps = 0
        self.draining = False
        self.drain_reason = None
        self._hb_stop = None
        self._hb_thread = None
        self.hb_failed = False

    # -- membership ----------------------------------------------------------
    def attach(self, bundle_sha=None):
        """Join the fleet: id, liveness FIRST, then discoverable state.
        Returns the replica id."""
        store = self.store
        self.bundle_sha = bundle_sha
        self.generation = fleet.current_generation(store)
        i = self.replica_id = store.add(fleet.k_nrep(), 1) - 1
        store.rank = fleet.REPLICA_RANK_BASE + i
        # liveness before anything the router could route to: a replica
        # killed here is a DETECTABLE corpse, never a wedged mailbox
        store.heartbeat()
        # heartbeats run on a DEDICATED thread over a cloned connection
        # — the serve loop blocks for seconds inside a prefill/decode
        # compile, and heartbeats riding it would starve into a false
        # death verdict (the FailureDetector dedicated-channel lesson)
        self._hb_stop = threading.Event()
        self._hb_thread = self._substrate.spawn(
            f"replica{i}-hb", self._hb_loop(store.clone()))
        if self.name is None:
            self.name = f"replica{i}"
        # live exposition: PADDLE_METRICS_PORT set → serve
        # /metrics off this process's registry and announce the
        # endpoint through the store so `observability.top` finds it;
        # unset → None, and the serve loop never touches it again
        from ...observability import expo
        self._expo = expo.start_if_configured()
        if self._expo is not None:
            expo.announce(store, self.name, self._expo.address)
        self._write_info()
        store.set(fleet.k_state(i), fleet.STATE_SERVING)
        trace.event("replica.join", replica=i, replica_name=self.name,
                    generation=self.generation)
        return i

    def _hb_loop(self, conn):
        def loop():
            i = self.replica_id
            while not self._clock.wait(self._hb_stop, self.hb_interval):
                try:
                    conn.heartbeat()
                    trace.event("replica.heartbeat", replica=i)
                except Exception as e:  # store gone: observable flag,
                    # never a silent thread death — the serve loop's own
                    # store ops surface the same loss as the exit path
                    self.hb_failed = True
                    self.hb_error = e
                    break
            conn.close()
        return loop

    def _write_info(self):
        info = {"name": self.name, "generation": self.generation,
                "bundle_sha": self.bundle_sha, "pid": os.getpid()}
        if self._expo is not None:
            info["metrics_addr"] = self._expo.address
        self.store.set(fleet.k_info(self.replica_id), json.dumps(info))

    # -- serve loop ----------------------------------------------------------
    def _check_control(self):
        """One control-plane read per loop: state key + generation.
        Flips ``draining`` (never back); a membership-only bump
        re-registers at the new generation instead."""
        i = self.replica_id
        st = fleet.read_state(self.store, i)
        if st in (fleet.STATE_DRAINING, fleet.STATE_DEAD,
                  fleet.STATE_STOPPED):
            self._start_drain("state:" + st.decode())
            return
        if self.stop is not None and self.stop.is_set():
            self._start_drain("local-stop")
            return
        gen = fleet.current_generation(self.store)
        if gen != self.generation:
            bundle = fleet.active_bundle(self.store, gen)
            if bundle is not None and self.bundle_sha is not None \
                    and bundle["sha256"] != self.bundle_sha:
                # model roll: this replica's weights are the OLD
                # version — drain out; a fresh replica gate-loads the
                # new bundle
                self._start_drain(f"model-roll:g{gen}")
                return
            self.generation = gen
            self._write_info()

    def _start_drain(self, reason):
        if not self.draining:
            self.draining = True
            self.drain_reason = reason
            trace.event("replica.drain_begin", replica=self.replica_id,
                        reason=reason)

    def _pull(self):
        """Admit routed requests from the mailbox — ONLY while serving.
        The pull cursor is published so a drain hands the router an
        exact never-admitted tail to re-route."""
        i = self.replica_id
        qn = self.store.add(fleet.k_qn(i), 0)
        admitted = 0
        while self.pulled < qn and not self.draining:
            key = fleet.k_q(i, self.pulled)
            if not self.store.check(key):
                break              # router wrote the counter first; the
                # slot lands a round-trip later — retry next loop
            rid = self.store.get(key).decode()
            self.pulled += 1
            payload = json.loads(self.store.get(fleet.k_req(rid)).decode())
            try:
                self.harness.admit(rid, payload)
                admitted += 1
            except RequestTooLarge as e:
                fleet.post_done(self.store, rid, {
                    "status": fleet.ST_TOO_LARGE, "error": str(e),
                    "replica": i, "generation": self.generation})
            except RequestTimeout:
                # burned in the mailbox: typed timeout, no prefill
                # wasted (the router's done CAS makes a concurrent
                # router-side expiry of the same rid safe)
                fleet.post_done(self.store, rid, {
                    "status": fleet.ST_TIMEOUT,
                    "replica": i, "generation": self.generation})
            except EngineOverloaded as e:
                # waiting queue at its admission bound: typed refusal
                # with a retry hint instead of queueing to deadline
                # death
                fleet.post_done(self.store, rid, {
                    "status": fleet.ST_OVERLOADED, "error": str(e),
                    "retry_after_s": 0.25,
                    "replica": i, "generation": self.generation})
        return admitted

    def _burning(self):
        """The fleet SLO burn signal the degradation ladder reads: the
        local engine's armed verdict when one is wired, plus the fleet
        flag polled on the heartbeat cadence (never per beat — N
        replicas reading the flag every loop tick is the probe-stampede
        class control_plane_scale meters)."""
        if self.slo is not None and self.slo.armed():
            return True
        now = self._clock.monotonic()
        if now >= self._flag_check_at:
            self._flag_check_at = now + self.hb_interval
            from ...observability import slo as slo_mod
            self._flag_up = slo_mod.flag_up(self.store)
        return self._flag_up

    def _publish_occ(self):
        occ = dict(self.harness.occupancy())
        occ.update(pulled=self.pulled, steps=self.steps)
        if self.degrade is not None:
            occ["degrade_level"] = self.degrade.level
        now = self._clock.monotonic()
        # coalesced: a gauge write per serve-loop tick is 1/poll store
        # round-trips per replica-second carrying no new information —
        # an idle 300-replica fleet hammered the store with ~6000
        # writes/s (pinned by the fleet_scale
        # model). Write only when the payload CHANGED (the router must
        # see queue depth move promptly) or the heartbeat-cadence
        # refresh is due (so a fresh joiner reading a stale-but-live
        # gauge is bounded by hb_interval).
        payload = json.dumps(occ, sort_keys=True)
        if payload != self._occ_last or now >= self._occ_pub_at:
            self._occ_last = payload
            self._occ_pub_at = now + self.hb_interval
            self.store.set(fleet.k_occ(self.replica_id), payload)
        # fleet metrics view: the registry snapshot
        # rides the membership store on the heartbeat cadence under this
        # replica's LIVENESS rank, so `metrics.fleet_snapshot(store,
        # live_timeout=...)` drops a SIGKILLed replica's gauges the
        # moment its heartbeat goes stale
        if now >= self._metrics_pub_at:
            self._metrics_pub_at = now + self.hb_interval
            metrics.publish(self.store,
                            fleet.REPLICA_RANK_BASE + self.replica_id)

    def run(self):
        """Serve until drained. Returns 0 (the drained exit)."""
        i = self.replica_id
        assert i is not None, "attach() first"
        while True:
            self._check_control()
            if not self.draining:
                self._pull()
            # overload control beat: walk the brownout
            # ladder off the local backlog/page signals + the fleet
            # burn flag, and shed the unserviceable waiting tail. A
            # draining replica is excluded — its queue is already
            # frozen and its tail is the router's to re-route.
            shed = []
            if self.degrade is not None and not self.draining:
                shed = self.degrade.tick(burning=self._burning())
            progressed = False
            # a shed beat must post its typed completions even when
            # the shed emptied the engine (busy would be False and the
            # harvest would never run)
            if self.harness.busy or shed:
                for rid, res in self.harness.step():
                    res.update(replica=i, generation=self.generation)
                    fleet.post_done(self.store, rid, res)
                    if self.slo is not None:
                        self.slo.record_request(
                            rid=rid, ttft_ms=res.get("ttft_ms"),
                            status=res.get("status"), replica=i)
                self.steps += 1
                progressed = True
            self._publish_occ()
            if self.slo is not None:
                self.slo.tick(self.store)
            if self.draining and not self.harness.busy:
                # in-flight all completed: hand the router the
                # never-admitted tail and leave
                self.store.set(fleet.k_drained(i), str(self.pulled))
                if fleet.read_state(self.store, i) != fleet.STATE_DEAD:
                    self.store.set(fleet.k_state(i), fleet.STATE_STOPPED)
                self._hb_stop.set()
                self._hb_thread.join(timeout=5)
                # a graceful departure retires its fleet-view series
                # (a deregistered rank is never in dead_ranks, so the
                # liveness scope alone would keep it forever)
                metrics.unpublish(self.store,
                                  fleet.REPLICA_RANK_BASE + i)
                if self._expo is not None:
                    from ...observability import expo
                    expo.unannounce(self.store, self.name)
                    # NEVER close the server: start_if_configured hands
                    # out the PROCESS-global singleton, which other
                    # in-process tenants (a router, a second embedded
                    # replica) share; it dies with the process
                self.store.deregister()
                trace.event("replica.drained", replica=i,
                            reason=self.drain_reason, pulled=self.pulled)
                return 0
            if not progressed:
                self._clock.sleep(self.poll)


# -- CLI ----------------------------------------------------------------------

def main(argv=None):
    import argparse
    import signal
    import threading

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.inference.serving.replica")
    ap.add_argument("--store", required=True, help="membership store H:P")
    ap.add_argument("--bundle", default=None,
                    help="model bundle dir (default: the generation's "
                         "published bundle path)")
    ap.add_argument("--poll", type=float, default=0.02)
    ap.add_argument("--hb-interval", type=float,
                    default=float(os.environ.get(
                        "PADDLE_SERVE_HB_INTERVAL", "1.0")))
    ap.add_argument("--name", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda; cpu is for "
                         "the tests)")
    args = ap.parse_args(argv)
    from ... import resolve_device
    device = resolve_device(args.device)

    from ...distributed.store import TCPStore
    host, _, port = args.store.rpartition(":")
    store = TCPStore(host=host or "127.0.0.1", port=int(port),
                     world_size=1, timeout=30.0)
    gen = fleet.current_generation(store)
    bundle_path = args.bundle
    # the ACTIVE bundle (inherited across membership-only bumps) gates
    # the load even when --bundle names a local path: a stale-version
    # replica must refuse to join, not serve old weights
    published = fleet.active_bundle(store, gen)
    # wait briefly for a published bundle when none was given locally
    deadline = time.monotonic() + 30.0
    while bundle_path is None and published is None:
        if time.monotonic() >= deadline:
            print("replica: no --bundle and no published bundle for "
                  f"generation {gen}", file=sys.stderr)
            return 2
        time.sleep(0.1)
        published = fleet.active_bundle(store, gen)
    if bundle_path is None:
        bundle_path = published["path"]
    expected = published["sha256"] if published is not None else None
    try:
        model, digest = load_bundle(bundle_path, expected_sha=expected,
                                    device=device)
    except BundleDigestError as e:
        print(f"replica: {e}", file=sys.stderr)
        return 5
    if device.type == "cuda":
        # every kernel built (or found built) before the replica attaches:
        # an nvcc build inside the serve loop would starve its heartbeats
        from ...ops import cuda_kernels as ck
        ck.build_kernels()
    from .engine import ServingConfig, ServingEngine
    # on CUDA the engine captures its decode (and verify) graphs here,
    # before the replica attaches (PADDLE_SERVE_COMPILE_CACHE lets it skip
    # their checks); prefill stays eager, so nothing is left to prewarm
    engine = ServingEngine(model, ServingConfig(), device=device)
    stop = threading.Event()
    prev_term = None
    try:
        # capture the previous disposition so it can be restored: a
        # second SIGTERM after the drain began must fall through to it
        # (signal-handler hygiene)
        prev_term = signal.signal(signal.SIGTERM,
                                  lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread (embedded use): drain via the store
    from ...observability import slo as slo_mod
    from . import degrade as degrade_mod
    degrade = degrade_mod.DegradationController(engine) \
        if degrade_mod.enabled_from_env() else None
    rep = ServingReplica(store, EngineHarness(engine), name=args.name,
                         poll=args.poll, hb_interval=args.hb_interval,
                         stop=stop, slo=slo_mod.from_env(),
                         degrade=degrade)
    from ...distributed.store import StoreOpTimeout
    try:
        rep.attach(bundle_sha=digest)
        print(f"REPLICA_ID={rep.replica_id}", flush=True)
        return rep.run()
    except (RuntimeError, StoreOpTimeout) as e:
        if isinstance(e, BundleDigestError):
            raise
        print(f"replica: membership store lost: {e}", file=sys.stderr)
        return 4
    finally:
        if prev_term is not None:
            try:
                signal.signal(signal.SIGTERM, prev_term)
            except ValueError:
                pass
        store.close()


if __name__ == "__main__":
    sys.exit(main())
