"""Elastic training's checkpoint digest gate (counterpart:
``paddle_tpu/distributed/elastic/__init__.py``, its ``verify_checkpoint``
only). The serving replica gates every model bundle through it; the rest
of the elastic plane (the relaunch manager, the failure detector, the
preemption hook) is still to port (ROADMAP A8).
"""
from __future__ import annotations

import os

from ...observability import trace as _obs_trace

__all__ = ["verify_checkpoint"]


def verify_checkpoint(path):
    """Integrity-check a checkpoint dir against its RECORDED digests:
    every ``<file>.sha256`` sidecar, plus the ``shard_digests`` map in
    ``metadata.json`` when present (both written by
    ``distributed/checkpoint.save_state_dict``). Returns ``(ok,
    reason)`` — ``reason`` names the failing file. A dir with no
    recorded digests verifies trivially (pre-digest checkpoints, and
    trainers with their own save formats, keep the plain ``.done``
    contract). Stdlib-only on purpose: it needs
    no torch."""
    with _obs_trace.span("checkpoint.verify", path=path) as sp:
        ok, reason = _verify_checkpoint_impl(path)
        sp.set_attrs(ok=ok, reason=reason or "")
    return ok, reason


def _verify_checkpoint_impl(path):
    import hashlib
    expected = {}  # filename -> hex digest
    try:
        names = os.listdir(path)
    except OSError as e:
        return False, f"unreadable checkpoint dir: {e}"
    for name in names:
        if name.endswith(".sha256"):
            try:
                with open(os.path.join(path, name)) as f:
                    expected[name[:-len(".sha256")]] = f.read().strip()
            except OSError as e:
                return False, f"unreadable digest sidecar {name}: {e}"
    meta_path = os.path.join(path, "metadata.json")
    if os.path.exists(meta_path):
        try:
            import json
            with open(meta_path) as f:
                expected.update(json.load(f).get("shard_digests") or {})
        except (OSError, ValueError) as e:
            return False, f"unreadable metadata.json: {e}"
    for name, digest in sorted(expected.items()):
        fpath = os.path.join(path, name)
        h = hashlib.sha256()
        try:
            with open(fpath, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
        except OSError as e:
            return False, f"missing/unreadable shard {name}: {e}"
        if h.hexdigest() != digest:
            return False, (f"{name} fails its recorded sha256 "
                           "(torn or bit-flipped write)")
    return True, None
