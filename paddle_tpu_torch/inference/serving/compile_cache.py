"""Compile cache: CUDA-graph capture of the serving engine's fixed-shape
steps, each held to its eager step once, with a digest-verified manifest
on disk (counterpart: ``paddle_tpu/inference/serving/compile_cache.py``).

The reference persists XLA executables keyed by the fingerprint of their
StableHLO, so a replica spawned by a scale event deserializes instead of
compiling. The port has no XLA program to fingerprint, and a CUDA graph
cannot be written to disk. What maps across:

- **The artifact** is a ``torch.cuda.CUDAGraph`` of one step at its exact
  shapes: decode at (max_batch, KQ = 1) and verify at (max_batch,
  KQ = spec_k + 1). On CUDA the engine captures both at init, with or
  without a cache directory: graph replay is how the port runs them.
  ``adopt`` captures ``step_fn`` at ``example_args`` and returns a
  ``CapturedStep``: a call copies each tensor argument that is not
  already the captured buffer into it, replays, and returns the captured
  outputs (valid until the next replay). A graph is bound to its
  engine's parameter and pool addresses, so capture is per engine.
  Prefill is not captured: it runs at the tail's exact length, so it has
  no bucket to capture.
- **The check.** A fresh graph is held to the eager step once, on live
  inputs: the caller's ``live()`` stages them into the captured input
  buffers (the engine: every slot active over pages of random K/V, at
  context lengths spread up to the model length, greedy and sampled rows
  mixed) and returns the tensors the step writes. The eager step runs,
  then the replay, which rewrites the same rows; the outputs and the
  written tensors must agree bit for bit, or ``adopt`` raises.
- **The entry** ``<dir>/<key>.ptgraph`` is a canonical JSON manifest of
  the program: its name, the argument shapes and dtypes, the model
  config, the device name and compute capability, the torch version and
  the hashed kernel libraries the capture launched
  (``ops/_build.py`` ``library_path``). ``key`` is the sha256 of that
  JSON; ``<key>.ptgraph.sha256`` is the digest sidecar. Writes are atomic
  (tmp + rename), so a crashed writer never leaves a torn entry a reader
  could trust.
- **What a hit saves** is the check. An entry is stored only after its
  program passed the check, so a digest-verified entry says that this
  program (these shapes, model config, device, torch version and kernel
  libraries) replays as its eager step does; the engine that finds it
  trusts its own capture without running the check. Without a cache
  directory every graph is checked.
- **Refusals.** A missing sidecar, a digest mismatch or an unreadable
  manifest refuses the entry with its reason: it is counted and traced
  (``cache.compile_refused``), then treated as a miss, so the check runs.
  A corrupt cache costs time, never correctness.
- **On CPU tensors** the engine steps eagerly: ``adopt`` returns
  ``step_fn`` unchanged, and the manifest, digest and refusal logic still
  run. **On CUDA tensors** a capture that fails raises: nothing falls
  back to the eager step.

Launch counts. A replay runs no Python, so the wrapper counts of
``ops/cuda_kernels.py`` would not see it. The capture records the
launches its own thread makes (``cuda_kernels.recording_launches``: a
capture runs nothing on the card, and a launch another thread makes
meanwhile is not the graph's), and every replay adds them to the counts.

Threads. Capture runs with ``capture_error_mode="thread_local"``, so CUDA
work that another thread (a second in-process replica) launches meanwhile
does not invalidate it.

Spans (docs/OBSERVABILITY.md): ``cache.compile_hit`` around a
digest-verified load, ``cache.compile_miss`` around the check and store
of a fresh entry (attrs ``program`` and ``key``), the
``cache.compile_refused`` event with its ``reason``, and ``fleet.prewarm``
around ``prewarm``.

Env knob: ``PADDLE_SERVE_COMPILE_CACHE`` names the directory (replicas
sharing it skip the checks one of them made); unset or empty, the engine
keeps no manifests and checks every graph it captures.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time

import torch

from ...observability import metrics, trace
from ...ops import _build
from ...ops import cuda_kernels as ck

COMPILE_CACHE_HITS = metrics.counter(
    "serving_compile_cache_hits", "digest-verified manifests found (the "
    "capture's check against the eager step skipped)")
COMPILE_CACHE_MISSES = metrics.counter(
    "serving_compile_cache_misses", "programs checked and stored fresh "
    "(cache miss or refused entry)")
COMPILE_CACHE_REFUSALS = metrics.counter(
    "serving_compile_cache_refusals", "cache entries refused at load "
    "(digest mismatch, missing sidecar, unreadable manifest)")
COMPILE_CACHE_GRAPHS = metrics.counter(
    "serving_compile_cache_graphs", "CUDA graphs captured")


def from_env(env=None):
    """A ``CompileCache`` when ``PADDLE_SERVE_COMPILE_CACHE`` names a
    directory, else None (no manifests kept: every graph is checked)."""
    path = (env or os.environ).get("PADDLE_SERVE_COMPILE_CACHE", "")
    return CompileCache(path) if path else None


def _leaves(obj):
    """The leaves of nested tuples, lists and dicts (dicts in key order)."""
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _leaves(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _leaves(v)]
    return [obj]


def _spec(leaf):
    if torch.is_tensor(leaf):
        return [list(leaf.shape), str(leaf.dtype).replace("torch.", "")]
    return repr(leaf)


class CapturedStep:
    """One step captured into a CUDA graph at fixed shapes (module doc)."""

    def __init__(self, graph, inputs, outputs, launches, program):
        self.graph = graph
        self.inputs = inputs          # the captured argument leaves
        self.outputs = outputs        # the captured result (same nesting)
        self.launches = launches      # {kernel: {route: n}} per replay
        self.program = program
        self.replays = 0

    def __call__(self, *args):
        leaves = _leaves(args)
        if len(leaves) != len(self.inputs):
            raise ValueError(f"{self.program}: called with {len(leaves)} "
                             f"argument leaves, captured with "
                             f"{len(self.inputs)}")
        for a, s in zip(leaves, self.inputs):
            if a is s:
                continue
            if torch.is_tensor(s):
                if tuple(a.shape) != tuple(s.shape) or a.dtype != s.dtype:
                    raise ValueError(
                        f"{self.program}: argument {tuple(a.shape)} "
                        f"{a.dtype} does not match the captured "
                        f"{tuple(s.shape)} {s.dtype}")
                if a.data_ptr() != s.data_ptr():
                    s.copy_(a)
            elif a != s:
                raise ValueError(f"{self.program}: argument {a!r} is not "
                                 f"the captured {s!r}")
        self.graph.replay()
        ck.add_launches(self.launches)
        self.replays += 1
        return self.outputs


def capture(step_fn, example_args, program):
    """Warm the step up on a side stream (libraries loaded, cuBLAS
    handles made), then capture it into a CUDA graph at
    ``example_args``. A capture that fails raises."""
    device = next(x for x in _leaves(example_args)
                  if torch.is_tensor(x)).device
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step_fn(*example_args)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with ck.recording_launches() as launches, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = step_fn(*example_args)
    except Exception as e:
        raise RuntimeError(f"CUDA-graph capture of {program} failed: "
                           f"{type(e).__name__}: {e}") from e
    COMPILE_CACHE_GRAPHS.inc()
    return CapturedStep(graph, _leaves(example_args), out, launches,
                        program)


def check(step_fn, example_args, captured, live=None):
    """Hold ``captured`` to the eager step on the inputs ``live()``
    stages into ``example_args`` (as they stand when ``live`` is None).
    ``live()`` returns (the tensors the step writes, a function that
    undoes the staging). The eager step runs first, then the replay,
    which rewrites the same rows; outputs and written tensors must be
    bit-identical, or this raises."""
    written, restore = live() if live is not None else ((), None)
    try:
        eager = [t.clone() for t in _leaves(step_fn(*example_args))]
        after = [t.clone() for t in written]
        replayed = _leaves(captured(*example_args))
        same = all(map(torch.equal, eager, replayed)) \
            and all(map(torch.equal, after, written))
    finally:
        if restore is not None:
            restore()
    if not same:
        raise RuntimeError(f"CUDA graph of {captured.program} replays "
                           f"differently from the eager step")


def adopt(step_fn, example_args, program, cache=None, meta=None,
          live=None):
    """The engine's program hook. Returns (the step to call, its
    manifest). On CUDA tensors the step is ``step_fn`` captured at
    ``example_args``' exact shapes, checked against the eager step
    (``check``) unless ``cache`` holds a digest-verified manifest of the
    program; a manifest checked here is stored in ``cache``. On CPU
    tensors the step is ``step_fn`` itself, and ``cache`` still looks up
    and stores the manifest."""
    device = next((x.device for x in _leaves(example_args)
                   if torch.is_tensor(x)), torch.device("cpu"))
    if device.type != "cuda":
        manifest = CompileCache.manifest(program, example_args, meta,
                                         device=device)
        if cache is not None:
            cache._ensure(manifest, check=None)
        return step_fn, manifest
    captured = capture(step_fn, example_args, program)
    manifest = CompileCache.manifest(program, example_args, meta,
                                     launches=captured.launches,
                                     device=device)
    run_check = lambda: check(step_fn, example_args,  # noqa: E731
                              captured, live)
    if cache is None:
        run_check()
    else:
        with cache._lock:
            cache.graphs += 1
        cache._ensure(manifest, check=run_check)
    return captured, manifest


class CompileCache:
    """Digest-verified manifests of captured steps (module doc)."""

    def __init__(self, path):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.refusals = 0
        self.stores = 0
        self.graphs = 0
        self._lock = threading.Lock()

    def _entry(self, key):
        return os.path.join(self.path, f"{key}.ptgraph")

    # -- key -----------------------------------------------------------------
    @staticmethod
    def manifest(program, example_args, meta=None, launches=None,
                 device=None):
        """The program's manifest: what the key is the sha256 of. ``meta``
        carries the caller's model config; ``launches`` the kernels the
        capture launched, recorded by their hashed library file."""
        if device is None:
            tensors = [x for x in _leaves(example_args) if torch.is_tensor(x)]
            device = tensors[0].device if tensors else torch.device("cpu")
        if device.type == "cuda":
            props = torch.cuda.get_device_properties(device)
            dev = {"type": "cuda", "name": props.name,
                   "capability": [props.major, props.minor]}
        else:
            dev = {"type": device.type}
        libs = sorted(_build.library_path(name).name
                      for name, routes in (launches or {}).items()
                      if any(routes.values()))
        return {"format": "ptgraph-v1", "program": program,
                "args": [_spec(x) for x in _leaves(example_args)],
                "meta": meta or {}, "device": dev,
                "torch": torch.__version__, "kernel_libraries": libs}

    @staticmethod
    def canonical(manifest):
        return json.dumps(manifest, sort_keys=True,
                          separators=(",", ":")).encode()

    @classmethod
    def key_of(cls, manifest):
        return hashlib.sha256(cls.canonical(manifest)).hexdigest()

    # -- store ---------------------------------------------------------------
    def store(self, key, blob):
        """Write ``blob`` under ``key`` atomically, then its sha256
        sidecar (the entry first: a reader that finds a sidecar finds the
        entry it covers)."""
        entry = self._entry(key)
        tmp = f"{entry}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, entry)
        with open(f"{tmp}.sha256", "w") as f:
            f.write(hashlib.sha256(blob).hexdigest())
        os.replace(f"{tmp}.sha256", f"{entry}.sha256")
        self.stores += 1

    # -- load ----------------------------------------------------------------
    def _read_verified(self, key, program):
        """The entry for ``key`` after the digest gate, or None. A missing
        entry is a silent miss; a present but unverifiable one is a
        refusal, counted and traced with its reason, then a miss."""
        entry = self._entry(key)
        try:
            with open(entry, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        reason = None
        try:
            with open(f"{entry}.sha256") as f:
                want = f.read().strip()
        except OSError:
            reason = "missing-digest-sidecar"
        else:
            if hashlib.sha256(blob).hexdigest() != want:
                reason = "digest-mismatch"
        if reason is None:
            try:
                json.loads(blob.decode())
            except (UnicodeDecodeError, ValueError):
                reason = "unreadable-manifest"
            else:
                if hashlib.sha256(blob).hexdigest() != key:
                    reason = "manifest-not-the-key"
        if reason is None:
            return blob
        self._refuse(key, program, reason)
        return None

    def _refuse(self, key, program, reason):
        with self._lock:
            self.refusals += 1
        COMPILE_CACHE_REFUSALS.inc()
        trace.event("cache.compile_refused", key=key[:12], program=program,
                    reason=reason)

    def lookup(self, manifest):
        """(key, hit): whether a digest-verified entry for ``manifest`` is
        on disk. Counts and traces the hit; a refusal is counted and traced
        by ``_read_verified``."""
        key = self.key_of(manifest)
        program = manifest["program"]
        t0 = time.perf_counter_ns()
        if self._read_verified(key, program) is None:
            return key, False
        # the hit span times the digest-verified load
        trace.complete_span("cache.compile_hit", t0, time.perf_counter_ns(),
                            program=program, key=key[:12])
        with self._lock:
            self.hits += 1
        COMPILE_CACHE_HITS.inc()
        return key, True

    def _ensure(self, manifest, check):
        """Look ``manifest`` up; on a miss run ``check`` (when given),
        then store the manifest. Returns the key."""
        key, hit = self.lookup(manifest)
        if hit:
            return key
        with trace.span("cache.compile_miss", program=manifest["program"],
                        key=key[:12]):
            with self._lock:
                self.misses += 1
            COMPILE_CACHE_MISSES.inc()
            if check is not None:
                check()
            self.store(key, self.canonical(manifest))
        return key

    # -- pre-warm ------------------------------------------------------------
    def prewarm(self, engine, background=True):
        """Ensure the manifests of the engine's whole program set (decode,
        and verify when speculative) are in this cache, so the replicas a
        scale event spawns over it skip the checks. The engine captured
        and checked (or found verified) each program at init; a manifest
        missing here is stored from the engine's record. ``background=True``
        returns the daemon thread immediately; False runs inline and
        returns the number of programs ensured."""
        if background:
            t = threading.Thread(
                target=self.prewarm, name="compile-cache-prewarm",
                kwargs={"engine": engine, "background": False}, daemon=True)
            t.start()
            return t
        with trace.span("fleet.prewarm", cache=self.path):
            for manifest in engine.programs.values():
                self._ensure(manifest, check=None)
        return len(engine.programs)
