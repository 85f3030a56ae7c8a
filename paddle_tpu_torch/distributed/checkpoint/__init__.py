"""paddle.distributed.checkpoint of the port: a checkpoint directory of
per-process shard files and one global ``metadata.json`` (counterpart:
``paddle_tpu/distributed/checkpoint/__init__.py``, same layout on disk).

- ``metadata.json`` records every tensor's global shape and dtype, the
  Python values of the state (numbers, strings, lists: a scheduler's
  state, ``@step``) and the sha256 of the coordinator's shard.
- ``shard_{rank}.pkl`` holds, per tensor key, a list of (index, array):
  the slice of the global tensor (one (start, stop) pair per dimension)
  and its values on the host; a ``.sha256`` sidecar beside it holds the
  digest of its bytes. A tensor that carries a placement (a TP piece, a
  ZeRO partition: ``sharding_api.Placement``) is written as the rank's
  slices of the global tensor, whose shape goes into the metadata, by
  the ranks at coordinate 0 of every mesh axis it is replicated over; a
  tensor without one is replicated and written by the coordinator only. Every file is written to a temporary name and then
  renamed, so a crash mid-write leaves no truncated file under a valid
  name.
- A bf16 tensor is stored as its int16 bits under the dtype "bfloat16"
  (NumPy has none); the JAX package's ml_dtypes bf16 slices read the same.
- ``load_state_dict`` verifies each shard's digest before unpickling it,
  cuts each destination's own slices (its placement's, or the whole
  tensor) out of whatever slices the shards hold and copies them into the
  destination in place, in its dtype and on its device: a checkpoint
  written by mp 2 loads into one process, one process's into mp 2, and
  one the JAX package wrote sharded over 8 devices into either.
- ``save_state_dict(..., async_save=True)`` takes every tensor's values
  before it returns (the next step may overwrite them): a host tensor by
  a host copy, a card tensor (whole or this rank's piece) by a copy on
  the card (the same stream's work, so it costs no host wait), which the
  background thread copies to the host on a stream of its own before it
  writes the files; the returned ``AsyncSaveHandle.wait()`` joins it. A
  replicated tensor is copied by the coordinator only.

The rank is ``torch.distributed.get_rank()`` when a process group is up,
else 0; with more than one rank a synchronous save ends in a barrier, so
every shard is on disk when any rank returns (every rank must call it).
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading

import numpy as np
import torch

from ...framework.io import bf16_tensor, host_array, read_pickle
from ..sharding_api import peek_default_mesh, placement_of
from ...observability import trace as _obs_trace
from ...tensor import Tensor

__all__ = ["save_state_dict", "load_state_dict", "AsyncSaveHandle"]

_META_FILE = "metadata.json"
_DIGEST_SUFFIX = ".sha256"


def _process_index():
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def _flatten_state(state_dict, prefix=""):
    flat = {}
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten_state(v, key))
        elif isinstance(v, Tensor):
            flat[key] = v._value
            if placement_of(v) is not None:
                flat[key]._placement = placement_of(v)
        else:
            flat[key] = v
    return flat


class AsyncSaveHandle:
    """Returned by ``save_state_dict(async_save=True)``: the values have
    been taken; ``wait()`` joins the background copy to the host and file
    write and raises its error, if any."""

    def __init__(self, thread):
        self._thread = thread
        self._exc = None

    def wait(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("async checkpoint write still in progress")
        if self._exc is not None:
            raise self._exc
        return True

    result = wait

    def done(self):
        return not self._thread.is_alive()


def _gather_host_shards(state_dict, coordinator_rank=0, snapshot=False):
    """The metadata and this process's shards, each value taken now (the
    next step may overwrite it in place): copied to the host, or with
    ``snapshot`` a card tensor copied on the card, for ``_to_host`` to
    bring over later."""
    meta = {"tensors": {}, "python_state": {}}
    shards = {}
    mesh = peek_default_mesh()
    coordinator = _process_index() == coordinator_rank
    for key, v in _flatten_state(state_dict).items():
        placement = placement_of(v)
        if placement is not None and not placement.writer(mesh):
            # a replica another rank writes: only its global shape
            meta["tensors"][key] = {
                "shape": list(placement.global_shape),
                "dtype": _dtype_tag(v.dtype)}
            continue
        if isinstance(v, torch.Tensor):
            if placement is None and not coordinator:
                continue   # replicated: the coordinator writes it
            if snapshot and v.is_cuda:
                array, tag = v.detach().clone(), _dtype_tag(v.dtype)
            else:
                array, tag = host_array(v, copy=True)
        elif isinstance(v, np.ndarray):
            array, tag = np.array(v), None
        else:
            meta["python_state"][key] = v
            continue
        shape = placement.global_shape if placement is not None \
            else tuple(array.shape)
        meta["tensors"][key] = {"shape": list(shape),
                                "dtype": tag or str(array.dtype)}
        if placement is not None:
            shards[key] = [(gi, array[tuple(slice(*p) for p in li)])
                           for li, gi in placement.pieces]
        elif coordinator:
            shards[key] = [(tuple((0, s) for s in array.shape), array)]
    return meta, shards


def _dtype_tag(dtype):
    """A torch dtype's name in the metadata (NumPy's, or "bfloat16")."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _to_host(shards):
    """The card snapshots among ``shards`` copied to the host, on a stream
    of this thread's own (the caller's stream keeps computing)."""
    snaps = [d for pieces in shards.values() for _, d in pieces
             if isinstance(d, torch.Tensor)]
    if not snaps:
        return shards
    stream = torch.cuda.Stream(snaps[0].device)
    with torch.cuda.stream(stream):
        return {key: [(idx, host_array(d)[0]
                       if isinstance(d, torch.Tensor) else d)
                      for idx, d in pieces]
                for key, pieces in shards.items()}


class _HashingWriter:
    """A file's ``write`` that also feeds each chunk to a sha256."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()
        self.nbytes = 0

    def write(self, chunk):
        self.sha.update(chunk)
        self.nbytes += memoryview(chunk).nbytes
        return self._f.write(chunk)


def _write_atomic(path, data, mode="wb"):
    with open(path + ".tmp", mode) as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def save_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    async_save=False):
    """Write this process's shard file and, on the coordinator, the global
    metadata under ``path`` (a directory). ``async_save=True`` returns an
    ``AsyncSaveHandle`` once the values are on the host."""
    os.makedirs(path, exist_ok=True)
    rank = _process_index()
    meta, shards = _gather_host_shards(state_dict, coordinator_rank,
                                       snapshot=async_save)
    if async_save and any(isinstance(d, torch.Tensor)
                          for pieces in shards.values() for _, d in pieces):
        # the writer's stream waits for the card copies just queued
        ready = torch.cuda.Event()
        ready.record()
    else:
        ready = None

    def write():
        with _obs_trace.span("checkpoint.save", path=path, rank=rank,
                             async_save=async_save) as sp:
            shard_name = f"shard_{rank}.pkl"
            shard_path = os.path.join(path, shard_name)
            if ready is not None:
                ready.synchronize()
            # the digest of the bytes on disk: load and latest_checkpoint
            # verify it, so a torn or bit-flipped shard is named, not
            # unpickled. The pickle streams to the file (the bytes of
            # pickle.dumps), hashed as it is written.
            with open(shard_path + ".tmp", "wb") as f:
                out = _HashingWriter(f)
                pickle.Pickler(out, protocol=4).dump(_to_host(shards))
            digest = out.sha.hexdigest()
            os.replace(shard_path + ".tmp", shard_path)
            sp.set_attrs(bytes=out.nbytes, tensors=len(meta["tensors"]))
            _write_atomic(shard_path + _DIGEST_SUFFIX, digest + "\n", "w")
            if rank == coordinator_rank:
                meta["shard_digests"] = {shard_name: digest}
                _write_atomic(os.path.join(path, _META_FILE),
                              json.dumps(meta), "w")

    if not async_save:
        write()
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized() and \
                torch.distributed.get_world_size() > 1:
            torch.distributed.barrier()
        return None
    handle = None

    def runner():
        try:
            write()
        except Exception as e:   # handed to the caller by wait()
            handle._exc = e

    # not a daemon: the interpreter's exit waits for the write
    handle = AsyncSaveHandle(threading.Thread(
        target=runner, daemon=False, name="ckpt-async-write"))
    handle._thread.start()
    return handle


def _storage_dtype(name):
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _as_storage(data, dtype):
    """A slice's array in the storage dtype (the JAX package's bf16 slices
    arrive as raw two-byte elements and are read as int16 bits)."""
    data = np.asarray(data)
    if data.dtype != dtype and data.dtype.kind == "V":
        return data.view(dtype)
    return data.astype(dtype, copy=False)


def _assemble(key, info, shard_files, want=None):
    """The region ``want`` (one (start, stop) per dimension; default the
    whole) of the global tensor ``key`` on the host, cut out of whatever
    slices the shard files hold."""
    shape = tuple(info["shape"])
    dtype = _storage_dtype(info["dtype"])
    pieces = [(tuple(tuple(p) for p in idx), _as_storage(data, dtype))
              for shards in shard_files for idx, data in shards.get(key, [])]
    if not pieces:
        raise KeyError(f"no shard found for {key}")
    want = tuple(tuple(p) for p in want) if want is not None else \
        tuple((0, s) for s in shape)
    out = next((data for idx, data in pieces if idx == want), None)
    if out is None:
        region = tuple(hi - lo for lo, hi in want)
        out = np.zeros(region, dtype)
        filled = np.zeros(region, bool)
        for idx, data in pieces:
            cut = [(max(a, c), min(b, d))
                   for (a, b), (c, d) in zip(idx, want)]
            if any(lo >= hi for lo, hi in cut):
                continue
            src = tuple(slice(lo - a, hi - a)
                        for (lo, hi), (a, _) in zip(cut, idx))
            dst = tuple(slice(lo - c, hi - c)
                        for (lo, hi), (c, _) in zip(cut, want))
            out[dst] = data[src]
            filled[dst] = True
        if not bool(filled.all()):
            raise ValueError(
                f"checkpoint incomplete for '{key}': missing slices (saved "
                "on more hosts than are present? copy all shard_*.pkl "
                "files)")
    if info["dtype"] == "bfloat16":
        return bf16_tensor(out)
    return torch.from_numpy(out)


def _read_shards(path, meta):
    digests = dict(meta.get("shard_digests") or {})
    shard_files = []
    for fname in sorted(os.listdir(path)):
        if not (fname.startswith("shard_") and fname.endswith(".pkl")):
            continue
        with open(os.path.join(path, fname), "rb") as f:
            raw = f.read()
        expected = digests.get(fname)
        sidecar = os.path.join(path, fname + _DIGEST_SUFFIX)
        if expected is None and os.path.exists(sidecar):
            with open(sidecar) as f:
                expected = f.read().strip()
        # verified before unpickling: a torn or bit-flipped shard is
        # named, never read as weights; a shard with no recorded digest
        # loads as it is
        if expected and hashlib.sha256(raw).hexdigest() != expected:
            raise ValueError(
                f"checkpoint shard corrupt: {fname} in {path} fails "
                "its recorded sha256 (torn or bit-flipped write); "
                "restore from an earlier checkpoint")
        shard_files.append(read_pickle(raw)[0])
    return shard_files


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0):
    """Fill ``state_dict``'s tensors in place from the checkpoint at
    ``path``, and its Python values by assignment (the caller passes the
    live model's or optimizer's ``state_dict`` as the skeleton). Returns
    ``state_dict``."""
    with _obs_trace.span("checkpoint.load", path=path):
        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        shard_files = _read_shards(path, meta)
        _fill(state_dict, "", meta, shard_files, path)
    return state_dict


@torch.no_grad()
def _fill(d, prefix, meta, shard_files, path):
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            _fill(v, key, meta, shard_files, path)
        elif isinstance(v, (Tensor, torch.Tensor)):
            if key not in meta["tensors"]:
                if key in meta["python_state"]:
                    continue
                raise KeyError(f"'{key}' not found in checkpoint {path}")
            dst = v._value if isinstance(v, Tensor) else v
            info = meta["tensors"][key]
            placement = placement_of(v) or placement_of(dst)
            want = placement.global_shape if placement is not None \
                else tuple(dst.shape)
            if tuple(info["shape"]) != tuple(want):
                raise ValueError(
                    f"shape mismatch for '{key}': checkpoint "
                    f"{tuple(info['shape'])}, destination {tuple(want)}")
            if placement is None:
                src = _assemble(key, info, shard_files)
                dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
                continue
            for li, gi in placement.pieces:
                src = _assemble(key, info, shard_files, gi)
                dst[tuple(slice(*p) for p in li)].copy_(
                    src.to(device=dst.device, dtype=dst.dtype))
        elif key in meta["python_state"]:
            d[k] = meta["python_state"][key]
