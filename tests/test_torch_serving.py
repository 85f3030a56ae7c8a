"""The port's serving plane (``paddle_tpu_torch/inference/serving``) on
the CPU: the allocator, block tables, prefix cache and scheduler cases of
``tests/test_serving.py`` run against the port, and the port's engine
held token for token against the JAX ``ServingEngine`` and JAX
``generate`` on the same weights (fp32, greedy).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _torch_helpers import tiny_models
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.inference.serving import ServingConfig as JConfig
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.inference.serving.sampling import \
    filter_logits as jax_filter_logits
from paddle_tpu_torch.inference.serving import (CacheFull, NGramSpeculator,
                                                PagedKVCache, PrefixCache,
                                                Request, ServingConfig,
                                                ServingEngine, serve)
from paddle_tpu_torch.inference.serving.kv_cache import BlockTable
from paddle_tpu_torch.inference.serving.prefix_cache import _chunk_keys
from paddle_tpu_torch.inference.serving.sampling import (filter_logits,
                                                         sample_tokens)
from paddle_tpu_torch.observability import trace

CPU = "cpu"


def _cache(num_pages=8, page_size=4, heads=2, head_dim=8):
    return PagedKVCache(1, num_pages, page_size, heads, head_dim, device=CPU)


# -- allocator and block tables ----------------------------------------------

class TestPagedKVCache:
    def test_pools_live_on_the_device_with_a_null_page(self):
        c = PagedKVCache(2, 8, 16, 2, 8, dtype="bfloat16", device=CPU)
        assert c.k.shape == (2, 8, 16, 16) and c.k.dtype == torch.bfloat16
        assert c.free_page_count == 7
        got = {c.allocate_page() for _ in range(7)}
        assert 0 not in got
        with pytest.raises(CacheFull):
            c.allocate_page()
        with pytest.raises(ValueError):
            c.free_page(0)
        c.free_page(3)
        assert c.allocate_page() == 3

    def test_block_table_boundary_allocation(self):
        c = _cache()
        t = BlockTable(c)
        pages, offs = t.append_slots(4)     # exactly one page
        assert len(set(pages)) == 1 and offs == [0, 1, 2, 3]
        p2, o2 = t.slot_for_append()        # crossing the boundary
        assert p2 != pages[0] and o2 == 0 and t.num_pages == 2
        assert t.release() == 2 and c.free_page_count == 7
        assert t.padded(4) == [0, 0, 0, 0]

    def test_release_routes_shared_pages_to_prefix_cache(self):
        c = _cache()
        pc = PrefixCache(c)
        t = BlockTable(c)
        t.append_slots(8)
        pc.publish([1, 2, 3, 4, 5, 6, 7, 8], t)
        assert t.shared == [True, True]
        t.release(pc)
        assert c.free_page_count == 5 and pc.reclaimable_pages == 2

    def test_device_rule(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            PagedKVCache(1, 8, 16, 2, 8)


# -- prefix cache -------------------------------------------------------------

class TestPrefixCache:
    def test_hash_chain_commits_to_whole_prefix(self):
        a = _chunk_keys([1, 2, 3, 4, 5, 6, 7, 8], 4)
        b = _chunk_keys([1, 2, 3, 4, 9, 9, 9, 9], 4)
        assert a[0] == b[0] and a[1] != b[1]
        assert a[1] != _chunk_keys([9, 2, 3, 4, 5, 6, 7, 8], 4)[1]

    def test_keys_equal_the_jax_package_keys(self):
        from paddle_tpu.inference.serving.prefix_cache import \
            _chunk_keys as jax_keys
        toks = list(range(1, 40))
        assert _chunk_keys(toks, 16) == jax_keys(toks, 16)

    def test_publish_lookup_acquire_release_reclaim(self):
        cache = _cache(num_pages=10)
        pc = PrefixCache(cache)
        t = BlockTable(cache)
        prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
        t.append_slots(len(prompt))
        assert pc.publish(prompt, t) == 2
        t.release(pc)
        keys, pages = pc.lookup(prompt)
        assert len(pages) == 2
        pc.acquire(keys[0])
        pc.acquire(keys[1])
        assert pc.reclaimable_pages == 0
        pc.release(pages[0])
        pc.release(pages[1])
        assert pc.reclaimable_pages == 2
        for _ in range(cache.free_page_count + 2):
            cache.allocate_page()
        assert pc.resident_pages == 0

    def test_publish_dedup_keeps_incumbent(self):
        cache = _cache(num_pages=10)
        pc = PrefixCache(cache)
        t1 = BlockTable(cache)
        t1.append_slots(4)
        pc.publish([1, 2, 3, 4], t1)
        t2 = BlockTable(cache)
        t2.append_slots(4)
        assert pc.publish([1, 2, 3, 4], t2) == 0
        assert not t2.shared[0]
        assert pc.lookup([1, 2, 3, 4])[1] == [t1.pages[0]]

    def test_try_acquire_truncates_at_a_reclaimed_page(self):
        cache = _cache(num_pages=10)
        pc = PrefixCache(cache)
        t = BlockTable(cache)
        prompt = [1, 2, 3, 4, 5, 6, 7, 8]
        t.append_slots(8)
        pc.publish(prompt, t)
        t.release(pc)
        keys, pages = pc.lookup(prompt)
        for _ in range(cache.free_page_count + 2):
            cache.allocate_page()
        assert pc.try_acquire(keys, pages) == ([], [])

    def test_disabled_cache_never_hits(self):
        cache = _cache(num_pages=10)
        pc = PrefixCache(cache, enabled=False)
        t = BlockTable(cache)
        t.append_slots(4)
        assert pc.publish([1, 2, 3, 4], t) == 0
        assert pc.lookup([1, 2, 3, 4]) == ([], [])


# -- rollback -----------------------------------------------------------------

class TestKVRollback:
    def test_truncate_frees_private_tail_pages(self):
        cache = _cache()
        t = BlockTable(cache)
        t.append_slots(11)
        assert t.truncate(5) == 1 and t.length == 5 and t.num_pages == 2
        t.append_slots(6)
        assert t.num_pages == 3
        t.release()
        assert cache.free_page_count == 7

    def test_truncate_to_page_boundary_and_to_zero(self):
        cache = _cache()
        t = BlockTable(cache)
        t.append_slots(8)
        assert t.truncate(8) == 0
        assert t.truncate(4) == 1
        assert t.truncate(0) == 1
        assert t.num_pages == 0 and cache.free_page_count == 7

    def test_truncate_rejects_bad_lengths(self):
        t = BlockTable(_cache())
        t.append_slots(5)
        with pytest.raises(ValueError):
            t.truncate(6)
        with pytest.raises(ValueError):
            t.truncate(-1)

    def test_truncate_refuses_shared_prefix_pages(self):
        cache = _cache()
        pc = PrefixCache(cache)
        owner = BlockTable(cache)
        owner.append_slots(8)
        pc.publish([1, 2, 3, 4, 5, 6, 7, 8], owner)
        keys, pages = pc.try_acquire(*pc.lookup([1, 2, 3, 4, 5, 6, 7, 8]))
        reader = BlockTable(cache)
        reader.adopt_shared(pages)
        reader.append_slots(3)
        reader.truncate(9)
        with pytest.raises(RuntimeError, match="shared"):
            reader.truncate(7)
        reader.truncate(8)
        reader.release(pc)
        owner.release(pc)


# -- the engine against the JAX package ---------------------------------------

@pytest.fixture(scope="module")
def models():
    """JAX and port GPTs with the same weights (d = 64, max_seq_len 96)."""
    return tiny_models(tied=True, seed=0, max_seq_len=96)


def _jax_generate(jm, prompt, n):
    out = jm.generate(paddle.to_tensor(np.asarray([prompt], "int64")),
                      max_new_tokens=n)
    return np.asarray(out._value)[0].tolist()[len(prompt):]


def _run_port(pm, prompts, n, **cfg):
    eng = ServingEngine(pm, ServingConfig(page_size=16, **cfg), device=CPU)
    reqs = [Request(p, max_new_tokens=n) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return eng, reqs


def _run_jax(jm, prompts, n, **cfg):
    eng = JEngine(jm, JConfig(page_size=16, **cfg))
    reqs = [JRequest(p, max_new_tokens=n) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return [r.output_tokens for r in reqs]


class TestEngineParity:
    def test_batch_prefix_hit_and_page_boundary_match_jax(self, models):
        jm, pm = models
        rng = np.random.RandomState(0)
        prefix = rng.randint(1, 128, 32).tolist()          # 2 full pages
        prompts = [rng.randint(1, 128, 5).tolist(),
                   rng.randint(1, 128, 16).tolist(),       # ends on a page
                   prefix + rng.randint(1, 128, 4).tolist(),
                   prefix + rng.randint(1, 128, 6).tolist()]
        eng, reqs = _run_port(pm, prompts, 6, max_batch=4)
        assert reqs[2].prefix_hit_tokens == 0
        assert reqs[3].prefix_hit_tokens == 32       # hit at prefill
        got = [r.output_tokens for r in reqs]
        assert got == _run_jax(jm, prompts, 6, max_batch=4)
        # the JAX engine equals JAX generate in its own tests; two of the
        # prompts are held against generate here as well
        for i in (1, 3):
            assert got[i] == _jax_generate(jm, prompts[i], 6)
        assert eng.cache.free_page_count + \
            eng.prefix_cache.resident_pages == eng.cache.num_pages - 1

    def test_eviction_under_pool_pressure_matches_jax(self, models):
        jm, pm = models
        rng = np.random.RandomState(4)
        prompts = [rng.randint(1, 128, 12).tolist() for _ in range(2)]
        eng, reqs = _run_port(pm, prompts, 24, max_batch=2, num_pages=5,
                              prefix_caching=False)
        assert eng.scheduler.evicted_total >= 1 and reqs[1].evictions >= 1
        got = [r.output_tokens for r in reqs]
        assert got == _run_jax(jm, prompts, 24, max_batch=2, num_pages=5,
                               prefix_caching=False)
        assert got == [_jax_generate(jm, p, 24) for p in prompts]
        assert eng.cache.free_page_count == eng.cache.num_pages - 1

    def test_speculation_gives_the_same_tokens(self, models):
        _, pm = models
        rng = np.random.RandomState(3)
        prompts = [rng.randint(1, 128, 6).tolist() * 3 for _ in range(3)]
        base_eng, base = _run_port(pm, prompts, 12, max_batch=4)
        spec_eng, spec = _run_port(pm, prompts, 12, max_batch=4, spec_k=3)
        assert [r.output_tokens for r in spec] == \
            [r.output_tokens for r in base]
        assert spec_eng.spec_verify_steps > 0
        assert spec_eng.spec_committed_total >= spec_eng.spec_verify_steps

    def test_sampled_speculation_gives_the_same_tokens(self, models):
        _, pm = models
        rng = np.random.RandomState(5)
        prompts = [rng.randint(1, 128, 5).tolist() * 2 for _ in range(3)]

        def run(spec_k):
            eng = ServingEngine(pm, ServingConfig(page_size=16, max_batch=4,
                                                  spec_k=spec_k), device=CPU)
            reqs = [Request(p, max_new_tokens=10, temperature=0.9, top_k=40,
                            top_p=0.95, seed=11 + i)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            return [r.output_tokens for r in reqs]

        assert run(0) == run(4)

    def test_serve_and_spans(self, models, tmp_path):
        _, pm = models
        trace.clear()
        trace.enable(str(tmp_path))
        try:
            done = serve(pm, [([3, 4, 5, 6], 3), ([7, 8, 9], 2)],
                         ServingConfig(page_size=16, max_batch=2),
                         device=CPU)
            events = trace.load_trace(trace.export())
        finally:
            trace.disable()
        assert sorted(len(r.output_tokens) for r in done) == [2, 3]
        names = {e["name"] for e in events}
        assert {"serve.step", "serve.prefill", "serve.decode_step"} <= names
        from paddle_tpu_torch.inference.serving import engine
        from paddle_tpu_torch.observability import metrics
        assert engine.SERVE_TOKENS.total() >= 5
        snap = metrics.snapshot()["metrics"]
        assert snap["serving_ttft_ms"]["series"][0]["count"] >= 2

    def test_engine_defaults_to_cuda(self, models, monkeypatch):
        _, pm = models
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ServingEngine(pm)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            serve(pm, [([1, 2, 3], 2)])

    def test_engine_refuses_rmsnorm_models_as_jax_does(self):
        jm, pm = tiny_models(seed=0, max_seq_len=96, use_rmsnorm=True)
        with pytest.raises(NotImplementedError) as jerr:
            JEngine(jm, JConfig(page_size=16))
        with pytest.raises(NotImplementedError) as perr:
            ServingEngine(pm, ServingConfig(page_size=16), device=CPU)
        assert str(perr.value) == str(jerr.value)

    def test_compile_cache_is_not_ported_yet(self, models, tmp_path):
        """Named before the cache was ported: ``compile_cache_dir`` used to
        raise. Now the config takes it, and the engine with the cache on
        serves the tokens of the engine with it off, plain and speculative
        (exact equality, fp32)."""
        _, pm = models
        rng = np.random.RandomState(9)
        prompts = [rng.randint(1, 128, n).tolist() for n in (7, 20, 33)]
        for spec_k in (0, 3):
            cfg = ServingConfig(compile_cache_dir=str(tmp_path / "cc"))
            assert cfg.compile_cache_dir == str(tmp_path / "cc")
            on, on_reqs = _run_port(pm, prompts, 8, spec_k=spec_k,
                                    compile_cache_dir=str(tmp_path / "cc"))
            assert on.compile_cache is not None
            _, off_reqs = _run_port(pm, prompts, 8, spec_k=spec_k)
            assert [r.output_tokens for r in on_reqs] \
                == [r.output_tokens for r in off_reqs]


class TestRollbackUnderPressure:
    def test_hash_chain_survives_rollback_and_eviction(self, models):
        # speculative run under page pressure: rollbacks and at least one
        # eviction, then a same-prefix request still hits the prefix cache
        _, pm = models
        rng = np.random.RandomState(4)
        shared = rng.randint(1, 128, 32).tolist()
        prompts = [shared + rng.randint(1, 128, 8).tolist()
                   for _ in range(3)]
        eng, reqs = _run_port(pm, prompts, 12, max_batch=3, num_pages=7,
                              spec_k=3)
        assert eng.scheduler.evicted_total > 0
        for r, p in zip(reqs, prompts):
            want = pm.generate(torch.tensor([p]), max_new_tokens=12)
            assert r.output_tokens == want[0, len(p):].tolist()
        assert eng.cache.free_page_count \
            + eng.prefix_cache.resident_pages == eng.cache.num_pages - 1
        late = Request(shared + [5, 6], max_new_tokens=4)
        eng.submit(late)
        eng.run_until_done()
        assert late.prefix_hit_tokens > 0


class TestSchedulerPolicy:
    def test_prefill_token_budget_paces_admissions(self, models):
        _, pm = models
        rng = np.random.RandomState(7)
        eng = ServingEngine(pm, ServingConfig(
            page_size=16, max_batch=4, prefill_token_budget=20), device=CPU)
        reqs = [Request(rng.randint(1, 128, 16).tolist(), max_new_tokens=2)
                for _ in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        assert sum(r.state != "waiting" for r in reqs) == 1
        eng.run_until_done()
        assert all(r.state == "finished" for r in reqs)

    def test_static_batching_blocks_admission_until_drain(self, models):
        _, pm = models
        rng = np.random.RandomState(6)
        eng = ServingEngine(pm, ServingConfig(page_size=16, max_batch=2),
                            device=CPU)
        eng.scheduler.static_batching = True
        reqs = [Request(rng.randint(1, 128, 8).tolist(), max_new_tokens=n)
                for n in (3, 6, 2)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        assert eng.scheduler.occupancy == 2
        eng.step()
        assert reqs[0].state == "finished" and reqs[2].state == "waiting"
        eng.run_until_done()
        assert all(r.state == "finished" for r in reqs)

    def test_submit_rejects_oversized_and_clamps_long_requests(self, models):
        _, pm = models
        rng = np.random.RandomState(13)
        eng = ServingEngine(pm, ServingConfig(page_size=16, max_batch=2,
                                              num_pages=4), device=CPU)
        with pytest.raises(ValueError):               # needs 4 > 3 usable
            eng.submit(Request(rng.randint(1, 128, 50).tolist(),
                               max_new_tokens=8))
        eng = ServingEngine(pm, ServingConfig(page_size=16, max_batch=2),
                            device=CPU)
        req = Request(rng.randint(1, 128, 90).tolist(), max_new_tokens=50)
        eng.submit(req)                               # 90 + 50 > 96
        assert req.max_new_tokens == 6
        eng.run_until_done()
        assert len(req.output_tokens) == 6

    def test_one_plan_round_cannot_double_book_free_pages(self, models):
        _, pm = models
        rng = np.random.RandomState(12)
        eng = ServingEngine(pm, ServingConfig(
            page_size=16, max_batch=2, num_pages=8, prefix_caching=False),
            device=CPU)
        reqs = [Request(rng.randint(1, 128, 40).tolist(), max_new_tokens=2)
                for _ in range(2)]                    # 3 pages + 1 each
        for r in reqs:
            eng.submit(r)
        eng.step()
        assert sum(r.state != "waiting" for r in reqs) == 1
        eng.run_until_done()
        assert all(r.state == "finished" for r in reqs)
        assert eng.cache.free_page_count == eng.cache.num_pages - 1

    def test_blocked_queue_head_does_not_inflate_prefix_stats(self, models):
        _, pm = models
        rng = np.random.RandomState(14)
        eng = ServingEngine(pm, ServingConfig(page_size=16, max_batch=1),
                            device=CPU)
        for n in (8, 2):
            eng.submit(Request(rng.randint(1, 128, 8).tolist(),
                               max_new_tokens=n))
        eng.run_until_done()
        assert eng.prefix_cache.lookups == 2

    def test_queue_limit_and_shed(self, models):
        from paddle_tpu_torch.inference.serving import EngineOverloaded
        _, pm = models
        eng = ServingEngine(pm, ServingConfig(page_size=16, max_batch=1,
                                              queue_limit=2), device=CPU)
        reqs = [Request([1, 2, 3], max_new_tokens=2, priority=p)
                for p in (0, 1)]
        for r in reqs:
            eng.submit(r)
        with pytest.raises(EngineOverloaded):
            eng.submit(Request([4, 5], max_new_tokens=2))
        shed = eng.scheduler.shed(1)
        assert shed == [reqs[0]] and reqs[0].state == "overloaded"


# -- sampling -----------------------------------------------------------------

def test_filter_logits_equals_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 50)).astype(np.float32) * 3
    temps = np.asarray([0.7, 1.0, 1.3, 0.5, 2.0, 1.0], np.float32)
    top_ks = np.asarray([0, 5, 0, 10, 1, 50], np.int32)
    top_ps = np.asarray([1.0, 1.0, 0.9, 0.8, 0.5, 0.95], np.float32)
    got = filter_logits(*map(torch.from_numpy,
                             (logits, temps, top_ks, top_ps))).numpy()
    want = np.asarray(jax_filter_logits(*map(jnp.asarray, (
        logits, temps, top_ks, top_ps))))
    np.testing.assert_array_equal(got, want)


def test_sampled_draws_depend_only_on_seed_and_position():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((1, 64)).astype(
        np.float32))

    def draw(seed, pos, batch_logits=None):
        lg = logits if batch_logits is None else batch_logits
        n = lg.shape[0]
        full = lambda v, dt: torch.full((n,), v, dtype=dt)
        return sample_tokens(lg, full(seed, torch.int64),
                             full(pos, torch.int64),
                             full(1.0, torch.float32),
                             full(0, torch.int64),
                             full(1.0, torch.float32))[0].item()

    # the same (seed, position) draws the same token whatever else rides
    # in the batch
    batch = torch.cat([logits, torch.randn(3, 64)])
    assert draw(7, 12) == draw(7, 12) == draw(7, 12, batch)
    # across seeds the draws follow softmax(logits)
    counts = np.bincount([draw(s, 12) for s in range(4000)], minlength=64)
    p = torch.softmax(logits[0], -1).numpy()
    assert np.abs(counts / 4000 - p).max() < 0.03
    # greedy rows ignore the key
    greedy = sample_tokens(logits, torch.tensor([3]), torch.tensor([5]),
                           torch.tensor([0.0]), torch.tensor([0]),
                           torch.tensor([1.0]))
    assert greedy.item() == int(logits.argmax())


def test_ngram_speculator_proposals():
    sp = NGramSpeculator(k=3, max_ngram=3)
    assert sp.propose([1, 2, 9, 8, 1, 2]) == [9, 8, 1]
    assert sp.propose([1, 2, 3, 4, 5]) == []
    assert sp.propose([7, 5, 7, 6, 7]) == [6, 7, 6]
    assert sp.propose([3, 9, 9, 9]) == [9, 9, 9]
    assert sp.proposals == 4 and sp.hits == 3
