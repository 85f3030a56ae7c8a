"""paddle.distributed.checkpoint of the port: a checkpoint directory of
per-process shard files and one global ``metadata.json`` (counterpart:
``paddle_tpu/distributed/checkpoint/__init__.py``, same layout on disk).

- ``metadata.json`` records every tensor's global shape and dtype, the
  Python values of the state (numbers, strings, lists: a scheduler's
  state, ``@step``) and the sha256 of the coordinator's shard.
- ``shard_{rank}.pkl`` holds, per tensor key, a list of (index, array):
  the slice of the global tensor (one (start, stop) pair per dimension)
  and its values on the host; a ``.sha256`` sidecar beside it holds the
  digest of its bytes. Every file is written to a temporary name and then
  renamed, so a crash mid-write leaves no truncated file under a valid
  name.
- A bf16 tensor is stored as its int16 bits under the dtype "bfloat16"
  (NumPy has none); the JAX package's ml_dtypes bf16 slices read the same.
- ``load_state_dict`` verifies each shard's digest before unpickling it,
  assembles every requested tensor from whatever slices the shards hold
  (so a checkpoint the JAX package wrote sharded over 8 devices loads
  whole) and copies it into the destination tensor in place, in the
  destination's dtype and on its device.
- ``save_state_dict(..., async_save=True)`` copies every tensor to the
  host before it returns (a blocking copy: the next step may overwrite
  the values) and writes the files on a background thread; the returned
  ``AsyncSaveHandle.wait()`` joins it.

The rank is ``torch.distributed.get_rank()`` when a process group is up,
else 0. In this slice each process writes whole tensors (the port has no
mesh yet); saving shards of a tensor split across processes and
resharding on load across process counts wait for the distributed data
plane (ROADMAP A7).
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
        else:
            flat[key] = v._value if isinstance(v, Tensor) else v
    return flat


class AsyncSaveHandle:
    """Returned by ``save_state_dict(async_save=True)``: the device-to-host
    copy has already happened; ``wait()`` joins the background file write
    and raises its error, if any."""

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


def _gather_host_shards(state_dict):
    """The metadata and this process's shards, every tensor copied to the
    host now (values may be overwritten in place by the next step, so
    this part is never deferred)."""
    meta = {"tensors": {}, "python_state": {}}
    shards = {}
    for key, v in _flatten_state(state_dict).items():
        if isinstance(v, torch.Tensor):
            array, tag = host_array(v, copy=True)
        elif isinstance(v, np.ndarray):
            array, tag = np.array(v), None
        else:
            meta["python_state"][key] = v
            continue
        meta["tensors"][key] = {"shape": list(array.shape),
                                "dtype": tag or str(array.dtype)}
        shards[key] = [(tuple((0, s) for s in array.shape), array)]
    return meta, shards


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
    meta, shards = _gather_host_shards(state_dict)

    def write():
        with _obs_trace.span("checkpoint.save", path=path, rank=rank,
                             async_save=async_save) as sp:
            shard_name = f"shard_{rank}.pkl"
            shard_path = os.path.join(path, shard_name)
            payload = pickle.dumps(shards, protocol=4)
            sp.set_attrs(bytes=len(payload), tensors=len(meta["tensors"]))
            # the digest of the bytes on disk: load and latest_checkpoint
            # verify it, so a torn or bit-flipped shard is named, not
            # unpickled
            digest = hashlib.sha256(payload).hexdigest()
            _write_atomic(shard_path, payload)
            _write_atomic(shard_path + _DIGEST_SUFFIX, digest + "\n", "w")
            if rank == coordinator_rank:
                meta["shard_digests"] = {shard_name: digest}
                _write_atomic(os.path.join(path, _META_FILE),
                              json.dumps(meta), "w")

    if not async_save:
        write()
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


def _assemble(key, info, shard_files):
    """The global tensor ``key`` on the host, from every slice the shard
    files hold."""
    shape = tuple(info["shape"])
    dtype = _storage_dtype(info["dtype"])
    pieces = [(tuple(tuple(p) for p in idx), _as_storage(data, dtype))
              for shards in shard_files for idx, data in shards.get(key, [])]
    if not pieces:
        raise KeyError(f"no shard found for {key}")
    whole = tuple((0, s) for s in shape)
    out = next((data for idx, data in pieces if idx == whole), None)
    if out is None:
        out = np.zeros(shape, dtype)
        filled = np.zeros(shape, bool)
        for idx, data in pieces:
            sl = tuple(slice(lo, hi) for lo, hi in idx)
            out[sl] = data
            filled[sl] = True
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
            src = _assemble(key, meta["tensors"][key], shard_files)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"shape mismatch for '{key}': checkpoint "
                    f"{tuple(src.shape)}, destination {tuple(dst.shape)}")
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
        elif key in meta["python_state"]:
            d[k] = meta["python_state"][key]
