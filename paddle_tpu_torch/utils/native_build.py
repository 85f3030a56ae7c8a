"""On-demand g++ build of the native runtime components (a copy of
``paddle_tpu/utils/native_build.py`` that builds into ``build/native/``:
``native/build/`` belongs to the JAX package).

Reference analog: the CMake build of `paddle/fluid/...` native targets [U].
Here native sources live in repo-root `native/` and compile lazily into
shared objects cached beside the package (keyed by source mtime), because
the deployment model is a source checkout, not a wheel; pybind11 is not in
the image so all native APIs are plain C ABIs consumed via ctypes."""
from __future__ import annotations

import os
import subprocess
import threading

_lock = threading.Lock()
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")


def build_shared(name, sources):
    """Compile ``sources`` (repo-root-relative) into build/native/lib<name>.so
    and return its path; rebuild only when a source is newer."""
    with _lock:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        out = os.path.join(_BUILD_DIR, f"lib{name}.so")
        srcs = [os.path.join(_REPO_ROOT, s) for s in sources]
        if os.path.exists(out) and all(
                os.path.getmtime(out) >= os.path.getmtime(s) for s in srcs):
            return out
        # build beside the target and rename into place: another process
        # (a test worker, a replica) may load the library meanwhile
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
               *srcs, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build of {name} failed:\n{proc.stderr}")
        os.replace(tmp, out)
        return out
