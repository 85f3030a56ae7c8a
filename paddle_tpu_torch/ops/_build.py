"""Build the hand-written CUDA kernels under ``paddle_tpu_torch/csrc``
and load them through ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface (no PyTorch headers),
so ``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/lib<name>-<hash>.so

The library lands in ``build/kernels/`` at the root of the checkout, named
by a hash of its source and flags, so an edited source never loads a
stale build. The build runs at first use (``load``); ``build`` starts
one ``nvcc`` per missing source, all at once, and is what a caller uses
to build every kernel up front. A failed build raises with the
compiler's output; nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS = {}


def nvcc_path():
    """``nvcc`` from PATH or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of paddle_tpu_torch are built "
        "from source with the CUDA toolkit")


def library_path(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names):
    """Build every library in ``names`` that is not built yet, one
    ``nvcc`` each, all started together. Returns {name: (seconds,
    compiler output)}; a built library reports (0.0, "")."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = (0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       time.perf_counter(), tmp, path)
    failed = []
    for name, (proc, t0, tmp, path) in procs.items():
        log, _ = proc.communicate()
        out[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load(name):
    """The loaded ``ctypes`` library for ``csrc/<name>.cu``, built on
    first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
