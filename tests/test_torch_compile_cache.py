"""The port's compile cache (``paddle_tpu_torch/inference/serving/
compile_cache.py``) on the CPU: the entry is named by the sha256 of its
manifest; a torn entry, a missing sidecar and a digest mismatch are each
refused with their reason traced, then treated as a miss; a second
instance over the same directory hits; an engine with the cache on
serves exactly the tokens of the engine with it off, whose tokens the
JAX engine's equal on the same weights (fp32, exact); and the check that
holds a captured step to its eager step runs on a live batch the engine
stages, and catches a replay that computes or writes something else. On
CPU tensors ``adopt`` returns the eager step: the graph capture itself
runs on the card (``tests/test_torch_cuda_kernels.py``).

The reference's cache serializes XLA executables, which the port has no
counterpart of, so the port's cache is held to the port's eager engine
and the eager engine to the JAX one."""
import hashlib
import json
import os

import numpy as np
import pytest

from _torch_helpers import tiny_models
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.inference.serving import ServingConfig as JConfig
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu_torch.inference.serving import (CompileCache, Request,
                                                ServingConfig, ServingEngine)
from paddle_tpu_torch.inference.serving import compile_cache as cc
from paddle_tpu_torch.observability import trace

CPU = "cpu"


@pytest.fixture(scope="module")
def models():
    return tiny_models(tied=True, seed=0, max_seq_len=96)


def _engine(pm, cache_dir=None, **cfg):
    cfg = dict(dict(page_size=16, max_batch=4), **cfg)
    return ServingEngine(pm, ServingConfig(compile_cache_dir=cache_dir,
                                           **cfg), device=CPU)


def _serve(eng, prompts, n):
    reqs = [Request(p, max_new_tokens=n) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return [r.output_tokens for r in reqs]


def _decode_manifest(eng):
    fn, args = eng.decode_capture_args()
    return CompileCache.manifest("serving/decode_step", args,
                                 eng.cache_meta())


def _refusals(events):
    return [e["args"]["reason"] for e in events
            if e["name"] == "cache.compile_refused"]


def test_entry_name_is_the_manifest_sha256(models, tmp_path):
    eng = _engine(models[1], str(tmp_path))
    man = _decode_manifest(eng)
    key = hashlib.sha256(CompileCache.canonical(man)).hexdigest()
    entry = tmp_path / f"{key}.ptgraph"
    assert entry.exists() and (tmp_path / f"{key}.ptgraph.sha256").exists()
    assert json.loads(entry.read_text()) == man
    assert (tmp_path / f"{key}.ptgraph.sha256").read_text() \
        == hashlib.sha256(entry.read_bytes()).hexdigest()
    assert man["program"] == "serving/decode_step"
    assert man["device"] == {"type": "cpu"} and man["kernel_libraries"] == []
    assert man["meta"]["model"]["num_layers"] == 2
    # the verify program at spec_k = 3 is a second, different entry
    eng3 = _engine(models[1], str(tmp_path), spec_k=3)
    assert eng3.compile_cache.misses == 1 and eng3.compile_cache.hits == 1
    assert len(list(tmp_path.glob("*.ptgraph"))) == 2
    # a change in shape is a different key
    other = _engine(models[1], str(tmp_path / "b"), max_batch=2)
    assert CompileCache.key_of(_decode_manifest(other)) != key


def test_cross_instance_hit(models, tmp_path):
    first = _engine(models[1], str(tmp_path))
    assert (first.compile_cache.hits, first.compile_cache.misses) == (0, 1)
    second = _engine(models[1], str(tmp_path))
    assert (second.compile_cache.hits, second.compile_cache.misses) \
        == (1, 0)
    assert second.compile_cache.refusals == 0
    assert cc.from_env({"PADDLE_SERVE_COMPILE_CACHE": str(tmp_path)}).path \
        == str(tmp_path)
    assert cc.from_env({}) is None


@pytest.mark.parametrize("corrupt", ["torn", "missing_sidecar",
                                     "digest_mismatch", "not_json"])
def test_bad_entry_refused_with_its_reason(models, tmp_path, corrupt):
    eng = _engine(models[1], str(tmp_path))
    key = CompileCache.key_of(_decode_manifest(eng))
    entry = tmp_path / f"{key}.ptgraph"
    side = tmp_path / f"{key}.ptgraph.sha256"
    blob = entry.read_bytes()
    if corrupt == "torn":
        entry.write_bytes(blob[:len(blob) // 2])
    elif corrupt == "missing_sidecar":
        side.unlink()
    elif corrupt == "digest_mismatch":
        side.write_text("0" * 64)
    else:
        bad = b"\xff not a manifest"
        entry.write_bytes(bad)
        side.write_text(hashlib.sha256(bad).hexdigest())
    trace.clear()
    trace.enable()
    try:
        again = _engine(models[1], str(tmp_path))
        events = trace.TRACER.chrome_events()
    finally:
        trace.disable()
        trace.clear()
    want = {"torn": "digest-mismatch", "missing_sidecar":
            "missing-digest-sidecar", "digest_mismatch": "digest-mismatch",
            "not_json": "unreadable-manifest"}[corrupt]
    assert _refusals(events) == [want]
    c = again.compile_cache
    assert (c.refusals, c.misses, c.hits) == (1, 1, 0)
    # the refused entry was treated as a miss and stored afresh
    assert entry.read_bytes() == blob
    assert side.read_text() == hashlib.sha256(blob).hexdigest()
    assert {"cache.compile_miss"} <= {e["name"] for e in events}


def test_engine_tokens_with_the_cache_equal_without_and_jax(models,
                                                            tmp_path):
    jm, pm = models
    rng = np.random.RandomState(12)
    prompts = [rng.randint(1, 128, n).tolist() for n in (3, 17, 40, 26, 9)]
    jeng = JEngine(jm, JConfig(page_size=16, max_batch=4))
    jreqs = [JRequest(p, max_new_tokens=10) for p in prompts]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_done()
    want = [list(r.output_tokens) for r in jreqs]
    for spec_k in (0, 4):
        off = _serve(_engine(pm, spec_k=spec_k), prompts, 10)
        on_eng = _engine(pm, str(tmp_path), spec_k=spec_k)
        on = _serve(on_eng, prompts, 10)
        assert on == off == want
        assert on_eng.decode_steps > 0


def test_prewarm_ensures_the_program_set(models, tmp_path):
    eng = _engine(models[1], spec_k=2)
    cache = CompileCache(str(tmp_path))
    trace.clear()
    trace.enable()
    try:
        assert cache.prewarm(eng, background=False) == 2
        t = cache.prewarm(eng, background=True)
        t.join(timeout=30)
        names = {e["name"] for e in trace.TRACER.chrome_events()}
    finally:
        trace.disable()
        trace.clear()
    assert "fleet.prewarm" in names and "cache.compile_hit" in names
    assert (cache.misses, cache.hits) == (2, 2)
    assert len(os.listdir(tmp_path)) == 4      # two entries, two sidecars


class _Replay:
    """Stands in for a captured step on the CPU: the eager step, then
    ``perturb`` applied to its outputs and arguments."""

    def __init__(self, fn, perturb=None):
        self.fn, self.perturb, self.program = fn, perturb, "probe"
        self.calls = []

    def __call__(self, *args):
        self.calls.append([int(c) for c in args[6]])
        out = self.fn(*args)
        return self.perturb(out, args) if self.perturb else out


@pytest.mark.parametrize("program", ["decode", "verify"])
def test_the_check_runs_on_a_live_batch(models, program):
    """Every slot of the staged batch is active (ctx > 0) over pages of
    its own, with contexts spread up to the model length; a replay equal
    to the eager step passes, one that returns other tokens or writes
    another pool row raises; either way the pages come back zeroed and
    free."""
    verify = program == "verify"
    eng = _engine(models[1], spec_k=3 if verify else 0)
    fn, args = eng.verify_capture_args() if verify \
        else eng.decode_capture_args()
    kq = 4 if verify else 1
    free = eng.cache.free_page_count
    live = lambda: eng._stage_check_batch(kq)  # noqa: E731
    faithful = _Replay(fn)
    cc.check(fn, args, faithful, live)
    ctx = faithful.calls[0]
    assert min(ctx) > 0 and len(set(ctx)) == len(ctx)
    assert max(ctx) == eng.max_model_len - kq + 1
    assert eng.cache.free_page_count == free
    assert not eng.cache.k.any() and not eng.cache.v.any()

    def other_tokens(out, a):
        return (out[0] + 1, out[1]) if verify else out + 1

    def other_row(out, a):
        a[1][0, int(a[7].flatten()[0]), 0, 0] += 1.0
        return out

    for perturb in (other_tokens, other_row):
        with pytest.raises(RuntimeError, match="replays differently"):
            cc.check(fn, args, _Replay(fn, perturb), live)
        assert eng.cache.free_page_count == free
        assert not eng.cache.k.any() and not eng.cache.v.any()
