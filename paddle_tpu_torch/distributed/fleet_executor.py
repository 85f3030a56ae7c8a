"""The fleet executor: actor-style DAG execution (counterpart:
``paddle_tpu/distributed/fleet_executor.py``; upstream
``paddle/fluid/distributed/fleet_executor/``: Carrier, Interceptor,
TaskNode).

The reference runs distributed (mostly pipeline-shaped) programs as a DAG
of TaskNodes, each served by an Interceptor actor that consumes messages
from upstream and emits to downstream, all owned by a per-rank Carrier.
Here each interceptor is a thread around its node's callable (on the card
it issues CUDA work from that thread, onto the current stream), and
microbatch streams flow through the DAG with bounded buffering and
backpressure. A stage that raises sends a failure downstream, and the
caller gets a ``RuntimeError`` naming the stage, never a hung join.

Grad mode and autocast are per thread in PyTorch: a callable that must
run without autograd enters ``torch.no_grad()`` itself.

The mailboxes are ``NativeBlockingQueue``s (``utils/native_runtime``:
the condition-variable ``BlockingQueue`` of ``native/runtime/runtime.cpp``,
as in the reference): a stage waiting for a message waits in native code
with the interpreter lock released.
"""
from __future__ import annotations

import threading

from ..utils.native_runtime import NativeBlockingQueue

__all__ = ["TaskNode", "Interceptor", "Carrier", "FleetExecutor"]

_STOP = object()


class TaskNode:
    """One unit of the DAG: ``fn(*inputs) -> output``, with edges.

    ``role`` mirrors the reference's node kinds ('compute' runs fn;
    'source' feeds the input stream; 'sink' collects outputs).
    max_run_times bounds how many microbatch messages the node processes
    per run (the reference's per-section run limit)."""

    def __init__(self, fn=None, name=None, role="compute",
                 max_run_times=None):
        self.fn = fn
        self.name = name or (getattr(fn, "__name__", "task"))
        self.role = role
        self.max_run_times = max_run_times
        self.upstreams = []
        self.downstreams = []

    def add_downstream(self, other):
        if other not in self.downstreams:
            self.downstreams.append(other)
        if self not in other.upstreams:
            other.upstreams.append(self)
        return other


class Interceptor(threading.Thread):
    """Actor serving one TaskNode: joins one message per upstream, applies
    fn, fans out to downstream inboxes. Errors propagate downstream so the
    sink reports them instead of deadlocking."""

    def __init__(self, node, inboxes, downstream_inboxes, capacity=8):
        super().__init__(daemon=True, name=f"interceptor:{node.name}")
        self.node = node
        self.inboxes = inboxes              # one queue per upstream
        self.downstream_inboxes = downstream_inboxes
        self._count = 0

    def run(self):
        while True:
            msgs = []
            stop = False
            for q in self.inboxes:
                m = q.get()
                if m is _STOP:
                    stop = True
                msgs.append(m)
            if stop:
                self._broadcast(_STOP)
                return
            err = next((m for m in msgs if isinstance(m, _Failure)), None)
            if err is not None:
                self._broadcast(err)
                continue
            try:
                out = self.node.fn(*msgs)
            except Exception as e:  # noqa: BLE001 -- sent downstream, raised on the caller
                out = _Failure(self.node.name, e)
            self._broadcast(out)
            self._count += 1
            if (self.node.max_run_times is not None
                    and self._count >= self.node.max_run_times):
                self._broadcast(_STOP)
                return

    def _broadcast(self, msg):
        for q in self.downstream_inboxes:
            q.put(msg)


class _Failure:
    def __init__(self, node_name, exc):
        self.node_name = node_name
        self.exc = exc


class Carrier:
    """Owns the interceptors of one rank: wires inbox queues along DAG
    edges, runs source->sink microbatch streams."""

    def __init__(self, capacity=8):
        self.capacity = capacity
        self.nodes = []

    def add_task(self, node):
        self.nodes.append(node)
        return node

    def run(self, feed, num_micro_batches=None):
        """``feed``: iterable of microbatch inputs for every source node
        (a single stream is broadcast to all sources). Returns the list of
        sink outputs in microbatch order."""
        sources = [n for n in self.nodes if not n.upstreams]
        sinks = [n for n in self.nodes if not n.downstreams]
        if not sources or not sinks:
            raise ValueError("carrier DAG needs at least one source and sink")

        edge_q = {}  # (up, down) -> queue
        for n in self.nodes:
            for d in n.downstreams:
                edge_q[(n, d)] = NativeBlockingQueue(self.capacity)
        source_q = {s: NativeBlockingQueue(self.capacity) for s in sources}
        sink_q = {s: NativeBlockingQueue(0) for s in sinks}

        interceptors = []
        for n in self.nodes:
            inboxes = ([source_q[n]] if not n.upstreams
                       else [edge_q[(u, n)] for u in n.upstreams])
            outs = ([sink_q[n]] if not n.downstreams
                    else [edge_q[(n, d)] for d in n.downstreams])
            interceptors.append(Interceptor(n, inboxes, outs, self.capacity))
        for it in interceptors:
            it.start()

        feed = list(feed)
        if num_micro_batches is not None:
            feed = feed[:num_micro_batches]
        for item in feed:
            for s in sources:
                source_q[s].put(item)
        for s in sources:
            source_q[s].put(_STOP)

        outputs = []
        for _ in feed:
            row = [sink_q[s].get() for s in sinks]
            for m in row:
                if isinstance(m, _Failure):
                    for it in interceptors:
                        it.join(timeout=1)
                    raise RuntimeError(
                        f"fleet_executor: task '{m.node_name}' failed"
                    ) from m.exc
            outputs.append(row[0] if len(row) == 1 else tuple(row))
        for it in interceptors:
            it.join(timeout=5)
        return outputs


class FleetExecutor:
    """Reference-facing facade: build a linear pipeline of callables (the
    common fleet-executor shape) or run a hand-wired Carrier DAG."""

    def __init__(self, capacity=8):
        self.carrier = Carrier(capacity)

    @classmethod
    def from_stages(cls, stages, capacity=8):
        ex = cls(capacity)
        prev = None
        for i, fn in enumerate(stages):
            node = ex.carrier.add_task(TaskNode(fn, name=f"stage{i}"))
            if prev is not None:
                prev.add_downstream(node)
            prev = node
        return ex

    def run(self, feed, num_micro_batches=None):
        return self.carrier.run(feed, num_micro_batches)
