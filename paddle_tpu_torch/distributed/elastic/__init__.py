"""Elastic training (counterpart: ``paddle_tpu/distributed/elastic/
__init__.py``; upstream's elastic launch controller).

- The checkpoint lifecycle: where a step's checkpoint lives
  (``checkpoint_path``), the digest gate (``verify_checkpoint``), the
  completion marker and retention (``mark_complete``, ``gc_checkpoints``),
  the newest complete and intact checkpoint (``latest_checkpoint``), the
  SIGTERM hook that takes a final checkpoint
  (``enable_preemption_checkpoint``) and the relaunch count
  (``restart_count``). The serving replica gates every model bundle
  through ``verify_checkpoint``.
- The one-node relaunch manager (``ElasticManager``, ``elastic_launch``):
  the pod runs through the launcher's ``run_pod``; when it fails it runs
  again, with ``PADDLE_RESTART_COUNT`` raised and a doubling backoff, up to
  ``max_restarts``, and the trainers resume from ``latest_checkpoint()``
  under ``PADDLE_ELASTIC_CKPT_DIR``.
- ``FailureDetector``: a thread that heartbeats this rank into the store
  and reports the ranks whose last beat (by the server's clock) is older
  than ``timeout``, once each death; ``pause_heartbeats`` makes this
  process look wedged to its peers.

The multi-node agent over the store is ``elastic.agent``, its rendezvous
``elastic.rendezvous``.
"""
from __future__ import annotations

import os
import signal
import sys
import time

from ...observability import trace as _obs_trace

__all__ = ["ElasticManager", "elastic_launch", "FailureDetector",
           "enable_preemption_checkpoint", "latest_checkpoint",
           "verify_checkpoint", "checkpoint_path", "mark_complete",
           "gc_checkpoints", "restart_count", "CKPT_DIR_ENV", "RESTART_ENV",
           "KEEP_CKPTS_ENV", "GENERATION_ENV"]

CKPT_DIR_ENV = "PADDLE_ELASTIC_CKPT_DIR"
RESTART_ENV = "PADDLE_RESTART_COUNT"
KEEP_CKPTS_ENV = "PADDLE_ELASTIC_KEEP_CKPTS"
GENERATION_ENV = "PADDLE_ELASTIC_GENERATION"


def checkpoint_path(step, ckpt_dir=None):
    """Canonical elastic checkpoint location for a step."""
    d = ckpt_dir or os.environ.get(CKPT_DIR_ENV, "./elastic_ckpt")
    return os.path.join(d, f"step_{step}")


def verify_checkpoint(path):
    """Integrity-check a checkpoint dir against its RECORDED digests:
    every ``<file>.sha256`` sidecar, plus the ``shard_digests`` map in
    ``metadata.json`` when present (both written by
    ``distributed/checkpoint.save_state_dict``). Returns ``(ok,
    reason)`` — ``reason`` names the failing file. A dir with no
    recorded digests verifies trivially (pre-digest checkpoints, and
    trainers with their own save formats, keep the plain ``.done``
    contract). Stdlib-only on purpose: it needs
    no torch."""
    with _obs_trace.span("checkpoint.verify", path=path) as sp:
        ok, reason = _verify_checkpoint_impl(path)
        sp.set_attrs(ok=ok, reason=reason or "")
    return ok, reason


def _verify_checkpoint_impl(path):
    import hashlib
    expected = {}  # filename -> hex digest
    try:
        names = os.listdir(path)
    except OSError as e:
        return False, f"unreadable checkpoint dir: {e}"
    for name in names:
        if name.endswith(".sha256"):
            try:
                with open(os.path.join(path, name)) as f:
                    expected[name[:-len(".sha256")]] = f.read().strip()
            except OSError as e:
                return False, f"unreadable digest sidecar {name}: {e}"
    meta_path = os.path.join(path, "metadata.json")
    if os.path.exists(meta_path):
        try:
            import json
            with open(meta_path) as f:
                expected.update(json.load(f).get("shard_digests") or {})
        except (OSError, ValueError) as e:
            return False, f"unreadable metadata.json: {e}"
    for name, digest in sorted(expected.items()):
        fpath = os.path.join(path, name)
        h = hashlib.sha256()
        try:
            with open(fpath, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
        except OSError as e:
            return False, f"missing/unreadable shard {name}: {e}"
        if h.hexdigest() != digest:
            return False, (f"{name} fails its recorded sha256 "
                           "(torn or bit-flipped write)")
    return True, None


def latest_checkpoint(ckpt_dir=None):
    """Newest complete AND INTACT checkpoint dir (by step) or None. A
    checkpoint is complete when its ``.done`` marker exists (writers
    create the marker LAST, so a crash mid-save never yields a half
    checkpoint). Completeness is necessary but not sufficient: a torn or
    bit-flipped shard under a valid ``.done`` would fail the restore leg
    AFTER detection and rendezvous already succeeded, so any checkpoint
    failing ``verify_checkpoint`` is skipped (with a logged reason) and
    the previous ``.done`` one is returned instead."""
    d = ckpt_dir or os.environ.get(CKPT_DIR_ENV, "./elastic_ckpt")
    if not os.path.isdir(d):
        return None
    done = []
    for name in os.listdir(d):
        if not name.startswith("step_"):
            continue
        path = os.path.join(d, name)
        if not os.path.exists(os.path.join(path, ".done")):
            continue
        try:
            step = int(name.split("_", 1)[1])
        except ValueError:
            continue
        done.append((step, path))
    for _, path in sorted(done, reverse=True):
        ok, reason = verify_checkpoint(path)
        if ok:
            return path
        print(f"elastic: skipping corrupt checkpoint {path}: {reason}",
              file=sys.stderr, flush=True)
    return None


def mark_complete(path, keep_last_k=None):
    """Write the completion marker (call after all shards are on disk),
    then garbage-collect old checkpoints: ``keep_last_k`` (or the
    ``PADDLE_ELASTIC_KEEP_CKPTS`` env contract, so launcher-managed
    trainers get retention without code changes) bounds the ``step_*``
    dirs a long elastic run accumulates. No limit configured → no GC
    (back-compat)."""
    with open(os.path.join(path, ".done"), "w") as f:
        f.write("1")
    if keep_last_k is None:
        try:
            keep_last_k = int(os.environ.get(KEEP_CKPTS_ENV, "0")) or None
        except ValueError:
            keep_last_k = None  # malformed knob: retention off, not a
            # trainer crash after every successful save
    if keep_last_k is not None:
        gc_checkpoints(os.path.dirname(os.path.abspath(path)),
                       keep_last_k=keep_last_k)


def gc_checkpoints(ckpt_dir=None, keep_last_k=3):
    """Delete old ``step_*`` checkpoint dirs, keeping the ``keep_last_k``
    newest COMPLETE ones. Safety invariants:

    - the newest ``.done`` checkpoint is NEVER deleted (``keep_last_k``
      is clamped to >= 1) — it is what relaunch-restore resumes from;
    - dirs newer than the newest complete step are never touched (they
      are in-progress saves, possibly another rank's);
    - incomplete dirs OLDER than the newest complete step are removed
      too (crash leftovers that latest_checkpoint() skips forever).

    Returns the list of deleted paths."""
    import shutil
    d = ckpt_dir or os.environ.get(CKPT_DIR_ENV, "./elastic_ckpt")
    if not os.path.isdir(d):
        return []
    steps = []
    for name in os.listdir(d):
        if not name.startswith("step_"):
            continue
        try:
            step = int(name.split("_", 1)[1])
        except ValueError:
            continue
        path = os.path.join(d, name)
        steps.append((step, path,
                      os.path.exists(os.path.join(path, ".done"))))
    done_steps = sorted(s for s, _, ok in steps if ok)
    if not done_steps:
        return []  # nothing restorable yet: delete nothing
    keep_last_k = max(1, int(keep_last_k))
    kept_done = set(done_steps[-keep_last_k:])
    newest_done = done_steps[-1]
    deleted = []
    for step, path, ok in steps:
        if step > newest_done or step in kept_done:
            continue
        shutil.rmtree(path, ignore_errors=True)
        deleted.append(path)
    return deleted


class ElasticManager:
    """Relaunch with restore: run the pod; when it fails, run it again with
    ``PADDLE_RESTART_COUNT`` raised, so the trainers resume from
    ``latest_checkpoint()``. Tearing the rest of the pod down when one rank
    fails is ``run_pod``'s job; this loop owns the restarts."""

    def __init__(self, max_restarts=3, min_backoff=1.0, max_backoff=30.0,
                 ckpt_dir=None):
        self.max_restarts = max_restarts
        self.min_backoff = min_backoff
        self.max_backoff = max_backoff
        self.ckpt_dir = ckpt_dir
        self.restarts = 0

    def run(self, cmd, nranks=1, master=None, log_dir=None, base_env=None):
        from ..env import find_free_port
        from ..launch.main import run_pod
        backoff = self.min_backoff
        while True:
            env = dict(base_env or os.environ)
            env[RESTART_ENV] = str(self.restarts)
            if self.ckpt_dir:
                env[CKPT_DIR_ENV] = self.ckpt_dir
            m = master or (f"127.0.0.1:{find_free_port()}"
                           if nranks > 1 else "")
            rd = None if log_dir is None else os.path.join(
                log_dir, f"restart_{self.restarts}")
            rc = run_pod(cmd, range(nranks), nranks, m, log_dir=rd,
                         base_env=env)
            if rc == 0:
                return 0
            if self.restarts >= self.max_restarts:
                print(f"elastic: giving up after {self.restarts} restarts "
                      f"(last rc={rc})", file=sys.stderr)
                return rc
            self.restarts += 1
            ckpt = latest_checkpoint(self.ckpt_dir)
            print(f"elastic: pod failed (rc={rc}); restart "
                  f"{self.restarts}/{self.max_restarts} from "
                  f"{ckpt or 'scratch'} in {backoff:.1f}s", file=sys.stderr)
            time.sleep(backoff)
            backoff = min(backoff * 2, self.max_backoff)


def elastic_launch(cmd, nranks=1, max_restarts=3, master=None, log_dir=None,
                   ckpt_dir=None, min_backoff=1.0):
    """One call: the pod under ``ElasticManager``, relaunched with restore
    up to ``max_restarts`` times."""
    return ElasticManager(max_restarts=max_restarts, ckpt_dir=ckpt_dir,
                          min_backoff=min_backoff).run(
        cmd, nranks=nranks, master=master, log_dir=log_dir)


_preempt_state = {"installed": False, "save_fn": None, "prev": None,
                  "exit_code": 0}


def enable_preemption_checkpoint(save_fn, exit_code=0):
    """Turn SIGTERM (a scheduler's preemption or maintenance notice) into
    a final checkpoint: ``save_fn()`` runs once, then the process exits
    cleanly so a relaunching manager (or the scheduler) can restore from
    it.

    Returns a disable() callable restoring the previous handler."""
    _preempt_state["save_fn"] = save_fn
    _preempt_state["exit_code"] = exit_code

    def _handler(signum, frame):
        # restore the previous handler FIRST: a second SIGTERM (the
        # scheduler losing patience mid-save_fn, or arriving after the
        # checkpoint was already taken) must force exit through the
        # default disposition instead of being silently swallowed by a
        # no-op re-entry
        prev = _preempt_state["prev"]
        signal.signal(signal.SIGTERM,
                      prev if prev is not None else signal.SIG_DFL)
        _preempt_state["installed"] = False
        fn = _preempt_state["save_fn"]
        if fn is None:
            # save_fn already consumed: re-deliver to the restored
            # disposition (default: terminate)
            os.kill(os.getpid(), signum)
            return
        _preempt_state["save_fn"] = None  # run once
        try:
            fn()
        finally:
            sys.exit(_preempt_state["exit_code"])

    prev = signal.signal(signal.SIGTERM, _handler)
    _preempt_state.update(installed=True, prev=prev)

    def disable():
        if _preempt_state["installed"]:
            signal.signal(signal.SIGTERM, _preempt_state["prev"])
            _preempt_state.update(installed=False, save_fn=None)

    return disable


def restart_count():
    """How many times a relaunching manager has restarted this trainer
    (``PADDLE_RESTART_COUNT``, 0 when unset)."""
    return int(os.environ.get(RESTART_ENV, "0"))


class FailureDetector:
    """Heartbeat-based failure detection over the ``TCPStore``: a thread
    heartbeats this rank every ``interval`` seconds and asks the server
    for the ranks whose last beat (by the server's monotonic clock) is
    older than ``timeout``, calling ``on_failure(dead_ranks)`` once for
    each newly dead set. A rank that comes back and dies again is
    reported again."""

    def __init__(self, store, interval=1.0, timeout=5.0, on_failure=None,
                 clock=None):
        from ..substrate import SYSTEM_CLOCK
        self.store = store
        self.interval = interval
        self.timeout = timeout
        self.on_failure = on_failure
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self._reported = set()
        self._stop = None
        self._thread = None
        self._hb_store = None
        self._hb_paused = False
        self.last_error = None
        self.failed = False

    def pause_heartbeats(self):
        """Stop sending heartbeats while the detector keeps polling: to
        its peers this process now looks wedged (socket alive, liveness
        silent). Safe in a signal handler (it sets a flag)."""
        self._hb_paused = True

    def resume_heartbeats(self):
        self._hb_paused = False

    def _prepare(self):
        """The loop's state without its thread: the stop event and a
        connection of its own (the main connection's lock is held across
        a blocking ``wait``, which would starve the heartbeats)."""
        import threading
        if self.store.rank is None:
            raise ValueError(
                "FailureDetector needs a rank-aware store "
                "(TCPStore(rank=...))")
        self._stop = threading.Event()
        self.last_error = None
        self.failed = False
        # clone(), so a ReplicatedStore's detector keeps its endpoints
        # and follows a failover too
        self._hb_store = self.store.clone()

    def _detector_loop(self):
        from ..store import StoreOpTimeout
        errors = 0
        while not self._stop.is_set():
            try:
                if not self._hb_paused:
                    self._hb_store.heartbeat()
                dead = set(self._hb_store.dead_ranks(self.timeout))
                errors = 0
            except (RuntimeError, StoreOpTimeout) as e:
                # a passing store error is retried; the third in a row
                # marks the store gone (``failed``), never a silent death
                errors += 1
                self.last_error = e
                if errors >= 3:
                    self.failed = True
                    break
                self._clock.wait(self._stop, self.interval)
                continue
            self._reported &= dead
            fresh = dead - self._reported
            if fresh and self.on_failure is not None:
                self._reported |= fresh
                try:
                    self.on_failure(sorted(fresh))
                except Exception as e:
                    # a raising callback must not end the thread; the
                    # ranks are reported again on the next sweep
                    self.last_error = e
                    self._reported -= fresh
            self._clock.wait(self._stop, self.interval)

    def start(self):
        import threading
        if self._thread is not None:
            return self
        self._prepare()
        self._thread = threading.Thread(target=self._detector_loop,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, deregister=True):
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if deregister and self._hb_store is not None:
            try:
                self._hb_store.deregister()
            except Exception:
                pass  # the store may be gone; peers reap the entry
        if self._hb_store is not None:
            self._hb_store.close()
            self._hb_store = None
