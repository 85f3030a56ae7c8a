"""``paddle.distributed.rpc`` of the port (counterpart:
``paddle_tpu/distributed/rpc/__init__.py``; upstream's rpc over brpc).

The user surface is upstream's (``init_rpc``, ``rpc_sync``, ``rpc_async``,
``shutdown`` and the worker-info queries) over plain TCP sockets:

- every worker serves requests on a thread, on a free port;
- the workers meet through the port's ``TCPStore``
  (``native/store/tcp_store.cpp``), each registering ``name -> rank, ip,
  port`` under ``rpc/worker/{rank}`` and reading every other's;
- a call pickles ``(fn, args, kwargs)`` to the target, which runs it on a
  thread and sends back the pickled result, or the exception, which the
  caller raises again.

As in the reference (and ``torch.distributed.rpc``), the transport trusts
the cluster: pickled payloads go only between the training processes of one
job, on ports negotiated through the job's own store.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from dataclasses import dataclass

from ..store import TCPStore

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos",
           "get_current_worker_info", "WorkerInfo"]


@dataclass(frozen=True)
class WorkerInfo:
    name: str
    rank: int
    ip: str
    port: int


class _RpcState:
    def __init__(self):
        self.name = None
        self.rank = None
        self.world_size = None
        self.workers = {}          # name -> WorkerInfo
        self.server = None         # listening socket
        self.server_thread = None
        self.store = None
        self.stopping = False


_S = _RpcState()


def _send_msg(sock, payload: bytes):
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_msg(sock) -> bytes:
    hdr = b""
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError("rpc peer closed")
        hdr += chunk
    (n,) = struct.unpack("<Q", hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("rpc peer closed mid-message")
        buf += chunk
    return bytes(buf)


def _serve_one(conn):
    try:
        req = pickle.loads(_recv_msg(conn))
        if req == "__shutdown__":
            _send_msg(conn, pickle.dumps(("ok", None)))
            return
        fn, args, kwargs = req
        try:
            result = ("ok", fn(*args, **kwargs))
        except Exception as e:  # ship the exception to the caller
            result = ("err", e)
        try:
            payload = pickle.dumps(result)
        except Exception:
            # unpicklable result/exception: the caller still deserves a
            # real error, not a dropped connection
            payload = pickle.dumps(
                ("err", RuntimeError(
                    f"rpc: remote {'exception' if result[0] == 'err' else 'result'}"
                    f" is not picklable: {result[1]!r}")))
        _send_msg(conn, payload)
    except (ConnectionError, OSError):
        pass
    finally:
        conn.close()


def _server_loop(srv):
    while not _S.stopping:
        try:
            conn, _ = srv.accept()
        except OSError:
            return  # socket closed by shutdown()
        threading.Thread(target=_serve_one, args=(conn,), daemon=True).start()


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """Join the RPC group as ``name``. The master endpoint defaults to
    ``PADDLE_MASTER`` (the launcher's env contract), the rank and world to
    ``PADDLE_TRAINER_ID`` and ``PADDLE_TRAINERS_NUM``."""
    if _S.name is not None:
        raise RuntimeError("init_rpc already called")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None \
        else int(rank)
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", 1)) \
        if world_size is None else int(world_size)
    master_endpoint = master_endpoint or os.environ.get(
        "PADDLE_MASTER", "127.0.0.1:0")
    host, port = master_endpoint.rsplit(":", 1)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("0.0.0.0", 0))
    srv.listen(128)
    my_port = srv.getsockname()[1]
    my_ip = "127.0.0.1" if host in ("127.0.0.1", "localhost") \
        else socket.gethostbyname(socket.gethostname())

    # op_timeout=0: init_rpc blocks until every peer registers, however
    # late, which the store's default op deadline would cut short
    store = TCPStore(host, int(port), is_master=(rank == 0),
                     world_size=world_size, rank=rank, op_timeout=0)
    store.set(f"rpc/worker/{rank}",
              pickle.dumps((name, rank, my_ip, my_port)))
    # collect every worker's card (wait() blocks until the key exists)
    workers = {}
    for r in range(world_size):
        key = f"rpc/worker/{r}"
        store.wait([key])
        n, rr, ip, p = pickle.loads(store.get(key))
        workers[n] = WorkerInfo(n, rr, ip, p)

    _S.name, _S.rank, _S.world_size = name, rank, world_size
    _S.workers, _S.store, _S.server = workers, store, srv
    _S.stopping = False
    _S.server_thread = threading.Thread(target=_server_loop, args=(srv,),
                                        daemon=True)
    _S.server_thread.start()


class FutureWrapper:
    """Matches the reference's returned future: .wait() returns the result
    or re-raises the remote exception."""

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._exc = None

    def _set(self, result=None, exc=None):
        self._result, self._exc = result, exc
        self._done.set()

    def wait(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("rpc future timed out")
        if self._exc is not None:
            raise self._exc
        return self._result


def _call(to, fn, args, kwargs, timeout):
    info = get_worker_info(to)
    if info is None:
        raise RuntimeError(f"unknown rpc worker '{to}'")
    with socket.create_connection((info.ip, info.port),
                                  timeout=None if timeout in (None, -1)
                                  else timeout) as s:
        _send_msg(s, pickle.dumps((fn, tuple(args or ()), dict(kwargs or {}))))
        status, payload = pickle.loads(_recv_msg(s))
    if status == "err":
        raise payload
    return payload


def rpc_sync(to, fn, args=None, kwargs=None, timeout=-1):
    _require_init()
    return _call(to, fn, args, kwargs, timeout)


def rpc_async(to, fn, args=None, kwargs=None, timeout=-1):
    _require_init()
    fut = FutureWrapper()

    def runner():
        try:
            fut._set(result=_call(to, fn, args, kwargs, timeout))
        except Exception as e:
            fut._set(exc=e)

    threading.Thread(target=runner, daemon=True).start()
    return fut


def shutdown(timeout=60.0):
    """Graceful: barrier so no worker tears down while peers still call.
    A dead peer must not hang teardown — after ``timeout`` we proceed."""
    if _S.name is None:
        return
    try:
        _S.store.barrier("rpc/shutdown", timeout=timeout)
    except (TimeoutError, RuntimeError, OSError):
        # a crashed peer's failures (key timeout, lost store, socket
        # error): tear down anyway; anything else propagates
        pass
    _S.stopping = True
    try:
        _S.server.close()
    except OSError:
        pass
    _S.server_thread.join(timeout=2)
    try:
        _S.store.close()
    except (RuntimeError, OSError):
        pass  # store connection already dead: teardown goal reached
    _S.__init__()


def get_worker_info(name=None):
    _require_init()
    if name is None:
        return _S.workers.get(_S.name)
    return _S.workers.get(name)


def get_all_worker_infos():
    _require_init()
    return sorted(_S.workers.values(), key=lambda w: w.rank)


def get_current_worker_info():
    return get_worker_info(None)


def _require_init():
    if _S.name is None:
        raise RuntimeError("call paddle.distributed.rpc.init_rpc first")
