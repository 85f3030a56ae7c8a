"""ctypes bindings for the native runtime core, ``native/runtime/runtime.cpp``
(counterpart: ``paddle_tpu/utils/native_runtime.py``): the host tracer that
``paddle_tpu_torch.profiler`` records ``RecordEvent`` spans into, the
condition-variable ``BlockingQueue`` between the DataLoader's workers and
its consumer and between the fleet executor's stages, and the host staging
allocator's counters.

``lib()`` builds ``runtime.cpp`` with ``g++`` into
``build/native/libpd_runtime.so`` at first use (``utils/native_build``; the
JAX package builds its own copy into ``native/build/``, and the two
libraries keep separate rings and queues in one process). Where the
reference returns ``None`` and carries on without the library, the port
raises with the compiler's message: no path falls back to ``queue.Queue``
or to a Python ring, so a run shows which queue and which tracer ran.

The reference's ``fastpath()`` (``native/runtime/fastpath.c``, a CPython
extension that canonicalises jax values and keys an XLA executable
cache) has no counterpart: the port's ``ops/dispatch.py`` keeps no such
cache.
"""
from __future__ import annotations

import ctypes
import os
import queue
import threading
import time

from . import native_build

_lock = threading.Lock()
_lib = None
_SLICE_MS = 100   # longest single wait in native code (signals run between)


def lib():
    """The ``libpd_runtime.so`` CDLL, built at first use. Raises
    RuntimeError with the compiler's output when the build fails."""
    global _lib
    if _lib is not None:   # lock-free once loaded: this sits on hot paths
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = native_build.build_shared(
            "pd_runtime", ["native/runtime/runtime.cpp"])
        L = ctypes.CDLL(path)
        L.pd_rt_now_ns.restype = ctypes.c_int64
        L.pd_rt_name_id.argtypes = [ctypes.c_char_p]
        L.pd_rt_name_id.restype = ctypes.c_int32
        L.pd_rt_trace_start.argtypes = []
        L.pd_rt_trace_stop.argtypes = []
        L.pd_rt_record.argtypes = [ctypes.c_int32, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64]
        L.pd_rt_record.restype = None
        L.pd_rt_trace_enabled.restype = ctypes.c_int
        L.pd_rt_event_count.restype = ctypes.c_long
        L.pd_rt_export_chrome.argtypes = [ctypes.c_char_p, ctypes.c_int]
        L.pd_rt_export_chrome.restype = ctypes.c_long
        L.pd_rt_events_snapshot.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_long]
        L.pd_rt_events_snapshot.restype = ctypes.c_long
        L.pd_rt_name_of.argtypes = [ctypes.c_int32, ctypes.c_char_p,
                                    ctypes.c_int]
        L.pd_rt_name_of.restype = ctypes.c_int
        L.pd_rt_queue_new.argtypes = [ctypes.c_int]
        L.pd_rt_queue_new.restype = ctypes.c_void_p
        L.pd_rt_queue_free.argtypes = [ctypes.c_void_p]
        L.pd_rt_queue_free.restype = None
        L.pd_rt_queue_close.argtypes = [ctypes.c_void_p]
        L.pd_rt_queue_close.restype = None
        L.pd_rt_queue_size.argtypes = [ctypes.c_void_p]
        L.pd_rt_queue_size.restype = ctypes.c_int
        L.pd_rt_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_int]
        L.pd_rt_queue_push.restype = ctypes.c_int
        L.pd_rt_queue_pop.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.c_int]
        L.pd_rt_queue_pop.restype = ctypes.c_int
        L.pd_rt_host_alloc.argtypes = [ctypes.c_uint64]
        L.pd_rt_host_alloc.restype = ctypes.c_void_p
        L.pd_rt_host_free.argtypes = [ctypes.c_void_p]
        L.pd_rt_host_free.restype = None
        L.pd_rt_host_stats.argtypes = [ctypes.POINTER(ctypes.c_uint64)] * 3
        L.pd_rt_host_stats.restype = None
        _lib = L   # set last: lock-free readers must see it ready
        return _lib


# -- the host tracer (used by paddle_tpu_torch.profiler) ---------------------

_name_ids = {}


def trace_start():
    """Clear the ring and start recording."""
    lib().pd_rt_trace_start()


def trace_stop():
    lib().pd_rt_trace_stop()


def trace_enabled():
    return bool(lib().pd_rt_trace_enabled())


def record(name, t0_ns, t1_ns, tid=None):
    """One complete event on the ring (dropped by the library while
    tracing is off); ``tid`` defaults to the caller's
    ``threading.get_ident()``, the tid the Python-side events use."""
    L = lib()
    nid = _name_ids.get(name)
    if nid is None:
        nid = _name_ids[name] = L.pd_rt_name_id(name.encode())
    L.pd_rt_record(nid, threading.get_ident() if tid is None else tid,
                   t0_ns, t1_ns)


def export_chrome(path, pid=None):
    """Write the ring as chrome-trace JSON; returns the number of events."""
    return lib().pd_rt_export_chrome(
        str(path).encode(), int(pid if pid is not None else os.getpid()))


def events_snapshot(max_rows=None):
    """Every event on the ring as [(name, tid, t0_ns, t1_ns), ...]."""
    L = lib()
    if max_rows is None:
        max_rows = max(int(L.pd_rt_event_count()), 1)
    buf = (ctypes.c_int64 * (4 * max_rows))()
    n = L.pd_rt_events_snapshot(
        ctypes.cast(buf, ctypes.POINTER(ctypes.c_int64)), max_rows)
    out = []
    name_buf = ctypes.create_string_buffer(256)
    names = {}
    for i in range(n):
        nid = int(buf[4 * i])
        if nid not in names:
            names[nid] = (name_buf.value.decode()
                          if L.pd_rt_name_of(nid, name_buf, 256) == 0
                          else "?")
        out.append((names[nid], int(buf[4 * i + 1]),
                    int(buf[4 * i + 2]), int(buf[4 * i + 3])))
    return out


# -- blocking queue over u64 tickets: native synchronisation, Python payloads


class NativeBlockingQueue:
    """Bounded blocking queue over the library's condition-variable queue
    (``capacity`` 0: unbounded).

    The native side synchronises on opaque u64 tickets; the Python objects
    wait in a table here, so producers and consumers block in native code
    (with the interpreter lock released) while the payloads stay
    reference-counted. ``put``/``get`` keep ``queue.Queue``'s meaning:
    ``queue.Full``/``queue.Empty`` when ``timeout`` runs out, and
    ``ValueError`` once the queue is closed (``get`` drains what is left
    first). A wait is cut into native waits of at most 100 ms, so signal
    handlers run meanwhile and a timeout fires at its deadline."""

    def __init__(self, capacity=0):
        self._L = lib()
        self._q = self._L.pd_rt_queue_new(int(capacity))
        self._items = {}
        self._items_lock = threading.Lock()
        self._ticket = 0

    @staticmethod
    def _waits(timeout):
        """Native wait slices (ms) until ``timeout`` (None: forever)."""
        if timeout is not None and timeout < 0:
            raise ValueError("'timeout' must be a non-negative number")
        deadline = None if timeout is None else time.monotonic() + timeout

        def slices():
            while True:
                if deadline is None:
                    yield _SLICE_MS
                    continue
                left_ms = int((deadline - time.monotonic()) * 1000)
                yield max(min(left_ms, _SLICE_MS), 0)
                if left_ms <= _SLICE_MS:
                    return
        return slices()

    def put(self, obj, timeout=None):
        waits = self._waits(timeout)
        with self._items_lock:
            self._ticket += 1
            t = self._ticket
            self._items[t] = obj
        rc = -1
        for ms in waits:
            rc = self._L.pd_rt_queue_push(self._q, t, ms)
            if rc != -1:
                break
        if rc == 0:
            return
        with self._items_lock:
            self._items.pop(t, None)
        if rc == -1:
            raise queue.Full
        raise ValueError("queue closed")

    def get(self, timeout=None):
        out = ctypes.c_uint64()
        rc = -1
        for ms in self._waits(timeout):
            rc = self._L.pd_rt_queue_pop(self._q, ctypes.byref(out), ms)
            if rc != -1:
                break
        if rc == -1:
            raise queue.Empty
        if rc != 0:
            raise ValueError("queue closed and drained")
        with self._items_lock:
            return self._items.pop(out.value)

    def qsize(self):
        return self._L.pd_rt_queue_size(self._q)

    def close(self):
        """Refuse further puts and wake every waiter; ``get`` still
        drains what is queued."""
        self._L.pd_rt_queue_close(self._q)

    def __del__(self):
        q, self._q = getattr(self, "_q", None), None
        if q:
            self._L.pd_rt_queue_close(q)
            self._L.pd_rt_queue_free(q)


def host_stats():
    """(current_bytes, peak_bytes, n_allocs) of the native staging pool."""
    L = lib()
    cur, peak, n = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
    L.pd_rt_host_stats(ctypes.byref(cur), ctypes.byref(peak), ctypes.byref(n))
    return (cur.value, peak.value, n.value)


class HostStagingBuffer:
    """64-byte-aligned host staging allocation, counted in
    ``host_stats()``, seen as a numpy array (``view``)."""

    def __init__(self, nbytes):
        self._L = lib()
        self._n = int(nbytes)
        self._p = self._L.pd_rt_host_alloc(self._n)
        if not self._p:
            raise MemoryError(f"host staging alloc of {nbytes} bytes failed")

    def view(self, dtype, shape):
        import numpy as np
        buf = (ctypes.c_char * self._n).from_address(self._p)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def free(self):
        if getattr(self, "_p", None):
            self._L.pd_rt_host_free(self._p)
            self._p = None

    def __del__(self):
        self.free()
