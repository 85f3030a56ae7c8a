"""The port's membership store (``paddle_tpu_torch/distributed/store.py``)
against the reference's (``paddle_tpu/distributed/store.py``): both bind
the same ``native/store/tcp_store.cpp``, so a port client talks to a
reference server and a reference client to a port server. Each direction
runs set/get, add, ``compare_set``, heartbeats with ``dead_ranks`` and
deregistration; every value is held exactly, liveness with margins of
half a second or more. The port builds its library
into ``build/native/``, never into the reference's ``native/build/``."""
import os
import time

import pytest

from paddle_tpu.distributed import store as jstore
from paddle_tpu_torch.distributed import store as pstore
from paddle_tpu_torch.utils import native_build

DIRECTIONS = {
    "port_client_reference_server": (jstore.TCPStore, pstore.TCPStore),
    "reference_client_port_server": (pstore.TCPStore, jstore.TCPStore),
}


@pytest.fixture(params=sorted(DIRECTIONS))
def pair(request):
    server_cls, client_cls = DIRECTIONS[request.param]
    server = server_cls(port=0, is_master=True, world_size=1)
    client = client_cls(port=server.port, world_size=1, timeout=10.0)
    yield server, client
    client.close()
    server.close()


def test_set_get_check_delete(pair):
    server, client = pair
    client.set("k/str", "value")
    client.set("k/bytes", b"\x00\xffraw")
    assert server.get("k/str") == b"value"
    assert server.get("k/bytes") == b"\x00\xffraw"
    assert client.check("k/str") and not client.check("k/absent")
    with pytest.raises(KeyError):
        client.get("k/absent")
    big = "x" * (1 << 17)            # past the first 64 KiB reply buffer
    server.set("k/big", big)
    assert client.get("k/big") == big.encode()
    assert client.delete_key("k/str") and not server.check("k/str")


def test_add_counts_across_both_clients(pair):
    server, client = pair
    assert client.add("n", 3) == 3
    assert server.add("n", 2) == 5
    assert client.add("n", 0) == 5
    assert client.add("n", -5) == 0


def test_compare_set_first_writer_wins(pair):
    server, client = pair
    # "" matches an absent key: the race-free initializer
    assert client.compare_set("gen", "", "0") == (b"0", True)
    assert server.compare_set("gen", "", "9") == (b"0", False)
    assert server.compare_set("gen", "0", "1") == (b"1", True)
    assert client.compare_set("gen", "0", "2") == (b"1", False)
    assert client.get("gen") == b"1"


def test_heartbeat_dead_ranks_and_deregister(pair):
    server, client = pair
    client.heartbeat(7)
    server.heartbeat(8)
    assert client.dead_ranks(30.0) == [] and server.dead_ranks(30.0) == []
    time.sleep(1.5)
    client.heartbeat(8)
    # rank 7 went quiet for 1.5 s, rank 8 just beat (the margins leave
    # room for a loaded machine)
    assert server.dead_ranks(1.0) == [7]
    assert client.dead_ranks(1.0) == [7]
    client.deregister(7)
    time.sleep(0.2)
    assert server.dead_ranks(0.1) == [8]


def test_port_builds_beside_the_package_not_into_the_reference():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native_build._BUILD_DIR == os.path.join(root, "build", "native")
    path = native_build.build_shared("pd_store",
                                     ["native/store/tcp_store.cpp"])
    assert path == os.path.join(root, "build", "native", "libpd_store.so")
    assert os.path.exists(path)


def test_store_op_timeout_is_a_timeout_error():
    assert issubclass(pstore.StoreOpTimeout, TimeoutError)
    server = pstore.TCPStore(port=0, is_master=True)
    clone = server.clone()
    try:
        clone.set("a", "1")
        assert server.get("a") == b"1"
    finally:
        clone.close()
        server.close()
