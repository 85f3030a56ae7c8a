"""The distributed environment (counterpart: ``paddle_tpu/distributed/
env.py``): ``init_parallel_env``, ``get_rank``, ``get_world_size``,
``ParallelEnv`` and ``ParallelMode`` over ``torch.distributed``.

One process is one rank, as in upstream Paddle on GPUs. The launcher
(``python -m paddle_tpu_torch.distributed.launch``) and ``spawn`` set the
reference's env contract before the user's code runs:
``PADDLE_TRAINER_ID`` (the rank), ``PADDLE_TRAINERS_NUM`` (the world),
``PADDLE_MASTER`` (``host:port`` of the rendezvous) and, per node,
``PADDLE_LOCAL_RANK`` and ``PADDLE_LOCAL_SIZE``.

The backend is named, never guessed behind the caller's back:
``init_parallel_env(backend=...)``, else ``PADDLE_DISTRI_BACKEND``, else
``nccl`` on the card and ``gloo`` on the CPU. A rank's card is
``cuda:(local_rank % device_count())``. NCCL refuses two ranks on one
card, so with ``nccl`` and more ranks on a node than cards it raises,
naming ``backend="gloo"``; gloo takes CUDA tensors and stages them
through the host.

The device rule holds: the rank runs on the card unless the caller asked
for the CPU (``device="cpu"``, or ``paddle.set_device("cpu")`` before the
call); without a card the default raises. A rank that joined a world
leaves it at exit (the comm plane drained, the process group destroyed)
unless it called ``destroy_process_group`` itself.
"""
from __future__ import annotations

import atexit
import datetime
import os
import socket

import torch
import torch.distributed as dist

BACKEND_ENV = "PADDLE_DISTRI_BACKEND"


def find_free_port(host="127.0.0.1"):
    """A free TCP port on ``host`` (the launcher's and spawn's rendezvous
    port when none is given)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


_device = None
_rank_override = None
_world_size_override = None


def _local_rank():
    return int(os.environ.get("PADDLE_LOCAL_RANK",
                              os.environ.get("PADDLE_TRAINER_ID", "0")))


def _local_size(world):
    return int(os.environ.get("PADDLE_LOCAL_SIZE", world))


def _rank_device(device):
    """The torch device this rank runs on: ``device`` when given, else the
    current place (``paddle.set_device``), which is the card by default."""
    from .. import resolve_device
    if device is None:
        from ..framework.place import _get_place
        place = _get_place()
        device = "cpu" if place.device_type == "cpu" else "cuda"
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda",
                              _local_rank() % torch.cuda.device_count())
    return device


class ParallelEnv:
    """``paddle.distributed.ParallelEnv``: this rank's place in the
    world."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return _local_rank()

    @property
    def device_id(self):
        d = get_device()
        return (d.index or 0) if d.type == "cuda" else 0

    @property
    def device(self):
        return get_device()

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def nrings(self):
        return 1


def init_parallel_env(backend=None, device=None, timeout=None):
    """Join the world the env contract describes and return a
    ``ParallelEnv``. A second call returns at once. ``timeout`` (seconds)
    bounds the rendezvous and every collective of the default group."""
    global _device
    if dist.is_initialized():
        return ParallelEnv()
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    master = os.environ.get("PADDLE_MASTER",
                            os.environ.get("MASTER_ENDPOINT", ""))
    dev = _rank_device(device)
    backend = (backend or os.environ.get(BACKEND_ENV)
               or ("nccl" if dev.type == "cuda" else "gloo")).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: the port runs "
                         "\"nccl\" or \"gloo\"")
    if backend == "nccl":
        if dev.type != "cuda":
            raise RuntimeError("the nccl backend needs a CUDA card; pass "
                               "backend=\"gloo\" to run on the CPU")
        cards = torch.cuda.device_count()
        if _local_size(world) > cards:
            raise RuntimeError(
                f"nccl runs one rank per card and this node has "
                f"{_local_size(world)} ranks on {cards} card(s); pass "
                "backend=\"gloo\" (or PADDLE_DISTRI_BACKEND=gloo) to share "
                "a card between ranks")
    if world > 1 and not master:
        raise RuntimeError("PADDLE_MASTER (host:port) is not set: start "
                           "the ranks through paddle_tpu_torch.distributed."
                           "launch or spawn")
    if not master:
        master = f"127.0.0.1:{find_free_port()}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{master}",
                            world_size=world, rank=rank, **kw)
    _device = dev
    atexit.register(_leave)
    return ParallelEnv()


def _leave():
    """At exit: wait for the comm plane's pending works, then tear the
    process group down (its threads must not outlive the interpreter)."""
    from .collective import destroy_process_group
    if dist.is_initialized():
        destroy_process_group()


def is_initialized():
    return dist.is_initialized()


def get_device():
    """The torch device of this rank (the card it was given, or the CPU);
    before ``init_parallel_env``, the current place's."""
    if _device is not None:
        return _device
    return _rank_device(None)


def get_rank(group=None):
    """This process's rank in ``group`` (the world by default): 0 in a
    world of one process."""
    if group is not None:
        return group.rank
    if _rank_override is not None:
        return _rank_override
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    if _world_size_override is not None:
        return _world_size_override
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def set_rank_world_size(rank=None, world_size=None):
    """Emulate a rank and world in one process (the samplers and loaders
    read them); ``None`` clears."""
    global _rank_override, _world_size_override
    _rank_override = rank
    _world_size_override = world_size


def is_available():
    return dist.is_available()


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
