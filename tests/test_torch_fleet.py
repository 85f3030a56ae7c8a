"""The port's serving fleet (``paddle_tpu_torch/inference/serving``:
``replica``, ``router``, ``fleet``, ``autoscaler``, ``degrade``, ``load``)
on the CPU, held to the JAX package.

- Bundles: a bundle the JAX package saves loads into the port; the
  port's bundle has the reference's file names and keys and verifies in
  both packages; a torn file or a wrong published sha256 refuses with
  ``BundleDigestError``.
- The in-process fleet (a port ``TCPStore``, a port router, replica
  threads over port engines on the CPU) runs the reference's
  ``TestInProcessFleet`` cases; every request's greedy tokens equal the
  JAX engine's on the same weights exactly (fp32).
- SIGKILL: real ``--device cpu`` replica processes under load, one
  killed; zero requests fail and the tokens stay exact.
- The engine-free objects decide alike: the reference's and the port's
  routers on the same store contents, autoscalers on the same signal
  sequences and degradation controllers on the same engine signals make
  the same decisions; ``synth_requests`` and ``summarize`` return equal
  values.

The tiny GPT is the reference fleet tests' (``_fleet_helpers.TINY_CFG``).
"""
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from _fleet_helpers import TINY_CFG, build_tiny_model, wait_until
from _torch_helpers import jax_state
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference.serving import autoscaler as jautoscaler
from paddle_tpu.inference.serving import degrade as jdegrade
from paddle_tpu.inference.serving import load as jload
from paddle_tpu.inference.serving import router as jrouter
from paddle_tpu_torch.convert import load_jax_gpt
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.inference.serving import (BundleDigestError,
                                                EngineHarness,
                                                ServingConfig, ServingEngine,
                                                ServingReplica,
                                                ServingRouter, fleet,
                                                load_bundle, save_bundle,
                                                speculative_accept)
from paddle_tpu_torch.inference.serving import autoscaler as pautoscaler
from paddle_tpu_torch.inference.serving import degrade as pdegrade
from paddle_tpu_torch.inference.serving import load as pload
from paddle_tpu_torch.text.gpt import GPTConfig, GPTForPretraining

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, int(n)).tolist() for n in lens]


# every (prompts, max_new_tokens) set the fleet tests serve; the JAX
# engine's tokens for all of them come from one run
ROUTE = (_prompts(4, (5, 13, 17)), 6)
DRAIN = (_prompts(5, (12,) * 4), 10)
SELF_DRAIN = (_prompts(8, (10,) * 3), 5)
BUMP = ([[1, 2, 3, 4]], 4)
KILL = (_prompts(6, np.random.RandomState(6).randint(6, 24, 10)), 12)
SETS = (ROUTE, DRAIN, SELF_DRAIN, BUMP, KILL)


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model on the CPU, JAX engine tokens by (prompt,
    max_new_tokens))."""
    jm = build_tiny_model()
    pm = GPTForPretraining(GPTConfig(**TINY_CFG), device=CPU).eval()
    load_jax_gpt(pm, jax_state(jm))
    eng = jserving.ServingEngine(jm, jserving.ServingConfig())
    reqs = {}
    for prompts, n in SETS:
        for p in prompts:
            if (tuple(p), n) not in reqs:
                reqs[tuple(p), n] = jserving.Request(p, max_new_tokens=n)
                eng.submit(reqs[tuple(p), n])
    eng.run_until_done()
    tokens = {k: list(r.output_tokens) for k, r in reqs.items()}
    return jm, pm, tokens


def _jax_tokens(models, prompt, n):
    return models[2][tuple(prompt), n]


# -- bundles ------------------------------------------------------------------

class TestBundles:
    def test_jax_bundle_loads_into_the_port(self, models, tmp_path):
        jm, pm, _ = models
        digest = jserving.save_bundle(jm, str(tmp_path / "b"))
        m2, dig2 = load_bundle(str(tmp_path / "b"), expected_sha=digest,
                               device=CPU)
        assert dig2 == digest
        for k, v in pm.state_dict().items():
            assert torch.equal(m2.state_dict()[k], v), k

    def test_port_bundle_is_the_reference_format(self, models, tmp_path):
        jm, pm, _ = models
        pdig = save_bundle(pm, str(tmp_path / "port"))
        jserving.save_bundle(jm, str(tmp_path / "jax"))
        assert sorted(os.listdir(tmp_path / "port")) \
            == sorted(os.listdir(tmp_path / "jax"))
        for name in ("config.json",):
            assert json.loads((tmp_path / "port" / name).read_text()) \
                == json.loads((tmp_path / "jax" / name).read_text())
        with np.load(tmp_path / "port" / "params.npz") as p, \
                np.load(tmp_path / "jax" / "params.npz") as j:
            assert sorted(p.files) == sorted(j.files)
            for k in p.files:
                np.testing.assert_array_equal(p[k], j[k])
        # the port's bundle verifies and loads in both packages
        jm2, jdig = jserving.load_bundle(str(tmp_path / "port"),
                                         expected_sha=pdig)
        pm2, pdig2 = load_bundle(str(tmp_path / "port"), expected_sha=pdig,
                                 device=CPU)
        assert jdig == pdig == pdig2
        assert np.array_equal(
            np.asarray(jm2.state_dict()["gpt.wte.weight"]._value),
            pm2.state_dict()["gpt.wte.weight"].numpy())

    def test_published_sha_mismatch_and_torn_file_refuse(self, models,
                                                         tmp_path):
        _, pm, _ = models
        d = tmp_path / "bundle"
        save_bundle(pm, str(d))
        with pytest.raises(BundleDigestError) as ei:
            load_bundle(str(d), expected_sha="0" * 64, device=CPU)
        assert "published" in str(ei.value)
        raw = bytearray((d / "params.npz").read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        (d / "params.npz").write_bytes(bytes(raw))
        with pytest.raises(BundleDigestError):
            load_bundle(str(d), device=CPU)
        with pytest.raises(jserving.BundleDigestError):
            jserving.load_bundle(str(d))


# -- the in-process fleet ----------------------------------------------------

class _Fleet:
    """A port ``TCPStore`` server, a port router and replica threads over
    port engines on the CPU (the reference test's ``_Fleet``)."""

    def __init__(self, model):
        self.model = model
        self.server = TCPStore(port=0, is_master=True, world_size=1)
        self.client = TCPStore(port=self.server.port, world_size=1)
        self.router = ServingRouter(self.client, hb_timeout=2.0, poll=0.01)
        self.threads, self.reps, self.stops, self.conns = [], [], [], []
        self.rcs = {}

    def add_replica(self, config=None, bundle_sha="sha-v0"):
        conn = TCPStore(port=self.server.port, world_size=1)
        eng = ServingEngine(self.model, config or ServingConfig(),
                            device=CPU)
        stop = threading.Event()
        rep = ServingReplica(conn, EngineHarness(eng), poll=0.005,
                             hb_interval=0.1, stop=stop)
        rep.attach(bundle_sha=bundle_sha)
        t = threading.Thread(
            target=lambda: self.rcs.__setitem__(rep.replica_id, rep.run()),
            daemon=True)
        t.start()
        self.reps.append(rep)
        self.stops.append(stop)
        self.threads.append(t)
        self.conns.append(conn)
        return rep

    def close(self):
        for s in self.stops:
            s.set()
        for t in self.threads:
            t.join(timeout=30)
        for c in self.conns:
            c.close()
        self.client.close()
        self.server.close()


@pytest.fixture
def fleet_h(models):
    f = _Fleet(models[1])
    yield f
    f.close()


class TestInProcessFleet:
    def test_route_complete_and_parity(self, models, fleet_h):
        fleet_h.add_replica()
        prompts, n = ROUTE
        rids = [fleet_h.router.submit(p, max_new_tokens=n) for p in prompts]
        res = fleet_h.router.await_results(rids, timeout=60)
        for rid, p in zip(rids, prompts):
            assert res[rid]["status"] == "ok"
            assert res[rid]["tokens"] == _jax_tokens(models, p, n)
            assert "ttft_ms" in res[rid]

    def test_graceful_drain_loses_nothing(self, models, fleet_h):
        a = fleet_h.add_replica()
        prompts, n = DRAIN
        rids = [fleet_h.router.submit(p, max_new_tokens=n) for p in prompts]
        b = fleet_h.add_replica()
        assert fleet_h.router.drain(a.replica_id, reason="scale-in")
        res = fleet_h.router.await_results(rids, timeout=60)
        for rid, p in zip(rids, prompts):
            assert res[rid]["status"] == "ok"
            assert res[rid]["tokens"] == _jax_tokens(models, p, n)
        wait_until(lambda: a.replica_id in fleet_h.rcs, 30,
                   desc="drained replica exit")
        assert fleet_h.rcs[a.replica_id] == 0
        assert fleet.read_state(fleet_h.client, a.replica_id) in (
            fleet.STATE_STOPPED, fleet.STATE_DEAD)
        # B re-registers at the generation the drain bumped on its next
        # serve-loop beat; then it is the one routable replica
        wait_until(lambda: [v.i for v in fleet_h.router._targets(
            fleet_h.router.discover())] == [b.replica_id], 30,
            desc="the survivor routable at the new generation")

    def test_self_drain_requeues_unpulled_mailbox(self, models, fleet_h):
        conn = TCPStore(port=fleet_h.server.port, world_size=1)
        fleet_h.conns.append(conn)
        eng = ServingEngine(models[1], ServingConfig(), device=CPU)
        stop = threading.Event()
        stop.set()
        a = ServingReplica(conn, EngineHarness(eng), poll=0.005,
                           hb_interval=0.1, stop=stop)
        a.attach(bundle_sha="sha-v0")
        prompts, n = SELF_DRAIN
        rids = [fleet_h.router.submit(p, max_new_tokens=n) for p in prompts]
        assert set(fleet_h.router.assigned.values()) == {a.replica_id}
        assert a.run() == 0          # drains, pulls nothing
        b = fleet_h.add_replica()
        res = fleet_h.router.await_results(rids, timeout=60)
        for rid, p in zip(rids, prompts):
            assert res[rid]["status"] == "ok"
            assert res[rid]["replica"] == b.replica_id
            assert res[rid]["tokens"] == _jax_tokens(models, p, n)
            assert fleet_h.router.requeues.get(rid)

    def test_router_deadline_timeout_with_no_replica(self, fleet_h):
        rid = fleet_h.router.submit([1, 2, 3], max_new_tokens=4,
                                    deadline_s=0.2)
        res = fleet_h.router.await_results([rid], timeout=30)
        assert res[rid]["status"] == "timeout"

    def test_too_large_request_completes_typed(self, fleet_h):
        fleet_h.add_replica(ServingConfig(page_size=16, num_pages=4,
                                          max_batch=2))
        rid = fleet_h.router.submit(list(range(1, 30)), max_new_tokens=60)
        res = fleet_h.router.await_results([rid], timeout=60)
        assert res[rid]["status"] == "too_large"
        assert "pages" in res[rid]["error"]

    def test_model_roll_drains_old_bundle_replica(self, fleet_h):
        a = fleet_h.add_replica(bundle_sha="sha-v1")
        gen = fleet.current_generation(fleet_h.client)
        fleet.publish_bundle(fleet_h.client, gen + 1, "/b/v2", "sha-v2")
        fleet.bump_generation(fleet_h.client, gen)
        wait_until(lambda: a.replica_id in fleet_h.rcs, 30,
                   desc="model-roll drain")
        assert fleet_h.rcs[a.replica_id] == 0
        assert a.drain_reason.startswith("model-roll")

    def test_membership_bump_same_bundle_rejoins(self, models, fleet_h):
        a = fleet_h.add_replica(bundle_sha="sha-v1")
        gen = fleet.current_generation(fleet_h.client)
        fleet.publish_bundle(fleet_h.client, gen + 1, "/b/v1", "sha-v1")
        fleet.bump_generation(fleet_h.client, gen)
        wait_until(
            lambda: json.loads(fleet_h.client.get(
                fleet.k_info(a.replica_id)).decode())["generation"]
            == gen + 1, 30, desc="re-join at the new generation")
        assert not a.draining
        (prompt,), n = BUMP
        rid = fleet_h.router.submit(prompt, max_new_tokens=n)
        res = fleet_h.router.await_results([rid], timeout=60)
        assert res[rid]["status"] == "ok"
        assert res[rid]["tokens"] == _jax_tokens(models, prompt, n)


# -- SIGKILL under load ------------------------------------------------------

class _ReplicaProc:
    def __init__(self, port, env, log_path):
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.serving."
             "replica", "--store", f"127.0.0.1:{port}", "--device", CPU,
             "--poll", "0.02", "--hb-interval", "0.2"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=self._log,
            text=True)
        line = self.proc.stdout.readline()
        assert line.startswith("REPLICA_ID="), (line,
                                                open(log_path).read())
        self.replica_id = int(line.strip().split("=", 1)[1])

    def kill(self):
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=15)

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._log.close()


def test_sigkill_replica_under_load_zero_failed_and_bit_exact(models,
                                                              tmp_path):
    """Two ``--device cpu`` replica processes serve a bundle the JAX
    package saved; the one holding the most routed work is SIGKILLed
    mid-load and more requests arrive. Every request completes ok, with
    the JAX engine's tokens exactly, and the victim's unfinished work was
    re-routed. Waits are bounded ``await_results``/``wait_until``."""
    jm = models[0]
    bundle = str(tmp_path / "bundle")
    digest = jserving.save_bundle(jm, bundle)
    server = TCPStore(port=0, is_master=True)
    client = TCPStore(port=server.port)
    fleet.publish_bundle(client, fleet.current_generation(client), bundle,
                         digest)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    reps = []
    try:
        for i in range(2):
            reps.append(_ReplicaProc(server.port, env,
                                     str(tmp_path / f"replica{i}.log")))
        router = ServingRouter(client, hb_timeout=2.0, poll=0.02)
        prompts, n = KILL
        rids = [router.submit(p, max_new_tokens=n) for p in prompts[:6]]
        wait_until(lambda: router.assigned, 10, desc="first assignment")
        by_load = {}
        for rid, i in router.assigned.items():
            by_load.setdefault(i, []).append(rid)
        victim_id = max(by_load, key=lambda i: len(by_load[i]))
        undone = [rid for rid in by_load[victim_id]
                  if not client.check(fleet.k_done(rid))]
        next(r for r in reps if r.replica_id == victim_id).kill()
        rids += [router.submit(p, max_new_tokens=n) for p in prompts[6:]]
        res = router.await_results(rids, timeout=120)
        assert all(r["status"] == "ok" for r in res.values()), \
            {rid: r["status"] for rid, r in res.items()}
        for rid, p in zip(rids, prompts):
            assert res[rid]["tokens"] == _jax_tokens(models, p, n), rid
        if undone:
            assert any(router.requeues.get(rid) for rid in undone)
        assert victim_id in router._dead
    finally:
        for r in reps:
            r.close()
        client.close()
        server.close()


# -- engine-free objects decide alike ----------------------------------------

def _fill_store(store, chain):
    """Three replicas at generation 0: r0 and r1 serving, r2 draining;
    r1 advertises ``chain`` (a prompt's prefix chain keys) as affinity."""
    store.compare_set(fleet.k_gen(), "", "0")
    store.add(fleet.k_nrep(), 3)
    occ = [{"free_pages": 40, "waiting": 1, "running": 2},
           {"free_pages": 30, "waiting": 0, "running": 1,
            "affinity": chain, "page_size": 16},
           {"free_pages": 90, "waiting": 0, "running": 0}]
    for i, state in enumerate((fleet.STATE_SERVING, fleet.STATE_SERVING,
                               fleet.STATE_DRAINING)):
        store.set(fleet.k_state(i), state)
        store.set(fleet.k_info(i), json.dumps({"name": f"r{i}",
                                               "generation": 0}))
        store.set(fleet.k_occ(i), json.dumps(occ[i]))


def test_router_decisions_equal_the_reference_on_the_same_store():
    from paddle_tpu_torch.inference.serving.prefix_cache import _chunk_keys
    rng = np.random.RandomState(11)
    shared = rng.randint(1, 128, 48).tolist()
    prompts = [shared + rng.randint(1, 128, 5).tolist() for _ in range(3)] \
        + [rng.randint(1, 128, 20).tolist() for _ in range(4)]
    chain = _chunk_keys(shared, 16)[::-1]
    out = {}
    for name, cls in (("jax", jrouter.ServingRouter),
                      ("port", ServingRouter)):
        server = TCPStore(port=0, is_master=True)
        try:
            _fill_store(server, chain)
            r = cls(server, hb_timeout=5.0, poll=0.01)
            rids = [r.submit(p, max_new_tokens=4) for p in prompts]
            first = [r.assigned[rid] for rid in rids]
            mailboxes = [[server.get(fleet.k_q(i, j)).decode()
                          for j in range(server.add(fleet.k_qn(i), 0))]
                         for i in range(3)]
            r.handle_death(0)
            # the survivor re-registers at the bumped generation
            server.set(fleet.k_info(1), json.dumps(
                {"name": "r1", "generation":
                 fleet.current_generation(server)}))
            r.dispatch()
            out[name] = (first, mailboxes, dict(r.assigned),
                         dict(r.requeues), fleet.read_state(server, 0),
                         fleet.current_generation(server))
        finally:
            server.close()
    assert out["port"] == out["jax"]
    first = out["port"][0]
    assert set(first[:3]) == {1} and 2 not in first    # affinity, no r2


SIGNALS = [
    [dict(n=0)], [dict(slo_burning=True)], [dict(backlog=3)],
    [dict(min_free_pages=4)], [dict(n=2, backlog=99)],
    [dict(), dict(), dict(), dict()],
    [dict(), dict(running=1), dict(), dict(degrade_level=2)],
    [dict(n=4, backlog=9), dict(n=4), dict(n=4), dict(n=4)],
]


@pytest.mark.parametrize("seq", SIGNALS, ids=lambda s: str(s)[:40])
def test_autoscaler_decisions_equal_the_reference(seq):
    cfg = dict(min_replicas=1, max_replicas=4, out_free_pages=8,
               out_backlog=2, idle_ticks=3, cooldown_s=0.0)
    verdicts = {}
    for name, mod in (("jax", jautoscaler), ("port", pautoscaler)):
        sc = mod.Autoscaler.__new__(mod.Autoscaler)
        sc.config = mod.AutoscalerConfig(**cfg)
        sc._idle_beats = 0
        base = {"n": 2, "backlog": 0, "running": 0, "min_free_pages": 64,
                "slo_burning": False}
        verdicts[name] = [sc._decide(dict(base, **s)) for s in seq]
    assert verdicts["port"] == verdicts["jax"]
    with pytest.raises(ValueError):
        pautoscaler.AutoscalerConfig(min_replicas=0)


class _StubEngine:
    """Duck-typed engine: the signals a degradation controller reads and
    the caps it applies."""

    class _Cfg:
        max_batch, page_size, prefill_token_budget, spec_k = 4, 16, 256, 4

    def __init__(self):
        self.config = self._Cfg()
        self.cache = type("C", (), {"num_pages": 64,
                                    "free_page_count": 60})()
        self.scheduler = type("S", (), {})()
        self.scheduler.waiting = []
        self.scheduler.shed = self._shed
        self.applied = []

    def _shed(self, n, reason="pressure"):
        out = self.scheduler.waiting[-n:]
        self.scheduler.waiting = self.scheduler.waiting[:-n]
        return out

    def apply_degradation(self, **caps):
        self.applied.append(caps)


def test_degradation_ladder_equals_the_reference():
    # (backlog, free pages, burning) per beat: escalate to the top under
    # backlog and burn, shed, then recover
    beats = [(20, 60, False)] * 7 + [(20, 2, True)] * 2 \
        + [(0, 60, False)] * 24
    runs = {}
    for name, mod in (("jax", jdegrade), ("port", pdegrade)):
        eng = _StubEngine()
        ctl = mod.DegradationController(eng, mod.DegradeConfig())
        levels, sheds = [], []
        for backlog, free, burning in beats:
            eng.scheduler.waiting = list(range(backlog))
            eng.cache.free_page_count = free
            sheds.append(len(ctl.tick(burning=burning)))
            levels.append(ctl.level)
        runs[name] = (levels, sheds, eng.applied,
                      [(d["from"], d["to"]) for d in ctl.decisions])
    assert runs["port"] == runs["jax"]
    assert max(runs["port"][0]) == pdegrade.MAX_LEVEL
    assert runs["port"][0][-1] == 0 and sum(runs["port"][1]) > 0


def test_degradation_drives_the_port_engine(models):
    eng = ServingEngine(models[1], ServingConfig(spec_k=3), device=CPU)
    ctl = pdegrade.DegradationController(
        eng, pdegrade.DegradeConfig(dwell_beats=1))
    for _ in range(pdegrade.MAX_LEVEL):
        ctl.tick(burning=True)
    assert ctl.level == pdegrade.MAX_LEVEL
    assert eng.degrade_spec_cap == ctl.cfg.spec_cap
    assert eng.scheduler.prefill_token_budget == ctl.cfg.prefill_cap
    assert eng.degrade_max_new_cap == ctl.cfg.max_new_cap


@pytest.mark.parametrize("kw", [
    dict(), dict(shared_prefix_len=24, shared_frac=0.5, seed=3),
    dict(max_new_dist="uniform", rate=5.0, deadline_s=2.0, seed=7)],
    ids=["default", "shared_prefix", "uniform_deadline"])
def test_synth_requests_equal_the_reference(kw):
    assert pload.synth_requests(20, 128, **kw) \
        == jload.synth_requests(20, 128, **kw)


def test_summarize_equals_the_reference():
    class R:
        def __init__(self, state, n, ttft, tpot):
            self.state, self.output_tokens = state, list(range(n))
            self.ttft_s, self.tpot_s = ttft, tpot

    class E:
        decode_steps, spec_verify_steps = 17, 5
        spec_accepted_total, spec_committed_total = 7, 12
        config = type("C", (), {"max_batch": 4})()
        scheduler = type("S", (), {"evicted_total": 2})()
        prefix_cache = type("P", (), {"lookups": 9, "hits": 3})()

    reqs = [R("finished", 5, 0.011, 0.002), R("finished", 9, 0.03, 0.004),
            R("timeout", 0, None, None), R("finished", 1, 0.02, None)]
    assert pload.summarize(reqs, 1.7, E()) == jload.summarize(reqs, 1.7,
                                                              E())
    assert pload.summarize(reqs, 0.5) == jload.summarize(reqs, 0.5)


def test_run_open_loop_serves_the_jax_tokens(models):
    sched = pload.synth_requests(4, 128, prompt_lens=(5, 20), max_new=(3, 6),
                                 seed=2)
    reqs, stats = pload.run_open_loop(models[1], sched, time_scale=0.0,
                                      device=CPU)
    assert stats["finished"] == 4
    jreqs, jstats = jload.run_open_loop(models[0], sched, time_scale=0.0)
    assert [r.output_tokens for r in reqs] \
        == [list(r.output_tokens) for r in jreqs]
    assert stats["output_tokens"] == jstats["output_tokens"]


def test_speculative_accept_commits_tokens_distributed_as_p():
    """The committed token follows p whatever q is: over 4000 (seed,
    position) keys, every token's frequency is within 0.03 of p."""
    torch.manual_seed(0)
    p_logits = torch.randn(6)
    q = torch.softmax(torch.randn(6) * 2, dim=-1)
    counts = torch.zeros(6)
    gen = torch.Generator().manual_seed(1)
    for s in range(4000):
        draft = int(torch.multinomial(q, 1, generator=gen))
        acc, tok = speculative_accept((s, 7), p_logits, q, draft)
        counts[int(tok)] += 1
        assert acc.dtype == torch.bool and tok.dtype == torch.int32
    p = torch.softmax(p_logits, dim=-1)
    assert (counts / counts.sum() - p).abs().max() < 0.03


def test_closed_loop_backoff_equals_the_reference(monkeypatch):
    """Under a pinned ``PADDLE_BACKOFF_SEED`` both clients draw the same
    jittered, capped backoff schedule, floored at the retry hint."""
    from paddle_tpu.distributed.substrate import NATIVE_SUBSTRATE as jsub
    from paddle_tpu_torch.distributed.substrate import \
        NATIVE_SUBSTRATE as psub
    monkeypatch.setenv("PADDLE_BACKOFF_SEED", "17")
    waits = {}
    for name, mod, sub in (("jax", jload, jsub), ("port", pload, psub)):
        router = type("R", (), {"_substrate": sub, "poll_interval": 0.01})()
        c = mod.ClosedLoopClient(router, base_backoff_s=0.05,
                                 max_backoff_s=1.0, name="t")
        waits[name] = [c._backoff(a, hint) for a in range(8)
                       for hint in (None, 0.7)]
    assert waits["port"] == waits["jax"]
    assert max(waits["port"]) <= 1.0
    assert min(waits["port"][1::2]) >= 0.35      # half the 0.7 s hint
