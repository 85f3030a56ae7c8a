"""``paddle.distributed.rpc`` of the port (``paddle_tpu_torch/distributed/
rpc``), as ``tests/test_rpc.py`` runs the reference's: two processes that
import only the port meet through the port's ``TCPStore`` and call
functions on each other (sync, async, a remote exception raised again at
the caller, the worker-info queries, a graceful shutdown). In one process:
the calls refused before ``init_rpc``."""
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import os, sys
sys.path.insert(0, %(root)r)
import paddle_tpu_torch.distributed.rpc as rpc

rank = int(os.environ["PADDLE_TRAINER_ID"])
rpc.init_rpc(f"worker{rank}")

infos = rpc.get_all_worker_infos()
assert [w.name for w in infos] == ["worker0", "worker1"], infos
assert rpc.get_current_worker_info().rank == rank
assert rpc.get_worker_info("nobody") is None

peer = f"worker{1 - rank}"
assert rpc.rpc_sync(peer, pow, args=(2, 10)) == 1024
assert rpc.rpc_sync(peer, max, args=([3, 9, 4],)) == 9
fut = rpc.rpc_async(peer, divmod, args=(7, 3))
assert fut.wait(timeout=30) == (2, 1)
try:
    rpc.rpc_sync(peer, divmod, args=(1, 0))
    raise SystemExit("expected ZeroDivisionError")
except ZeroDivisionError:
    pass
try:
    rpc.rpc_sync("nobody", pow, args=(1, 1))
    raise SystemExit("expected RuntimeError")
except RuntimeError:
    pass
rpc.shutdown()
assert "paddle_tpu" not in {m.split(".")[0] for m in sys.modules}
print(f"RPC_OK rank={rank}")
""" % {"root": ROOT}


def test_two_process_rpc():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "PADDLE_TRAINER_ID")}
    env_base.update(PADDLE_TRAINERS_NUM="2",
                    PADDLE_MASTER=f"127.0.0.1:{port}", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER],
        env=dict(env_base, PADDLE_TRAINER_ID=str(rank)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = [p.communicate(timeout=110)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"RPC_OK rank={rank}" in out


def test_calls_before_init_raise():
    import paddle_tpu.distributed.rpc as jrpc

    import paddle_tpu_torch.distributed.rpc as rpc
    for mod in (jrpc, rpc):
        with pytest.raises(RuntimeError, match="init_rpc"):
            mod.rpc_sync("w", pow, args=(1, 1))
        with pytest.raises(RuntimeError, match="init_rpc"):
            mod.get_worker_info()
        mod.shutdown()          # a no-op before init
    assert set(rpc.__all__) == set(jrpc.__all__)
