"""Typed flag registry: ``FLAGS_*`` from the environment and
``paddle.set_flags``/``get_flags`` (upstream ``paddle/utils/flags``).

Counterpart: ``paddle_tpu/utils/flags.py``, copied: ``define_flag``,
``set_flags``, ``get_flags``, ``get_flag`` and the lock-free ``FAST``
mirror that the per-op seam (``ops/dispatch.py``) reads on every op.
Values seed from the environment when a flag is defined."""
from __future__ import annotations

import os
import threading
import types

_lock = threading.Lock()
_registry: dict[str, dict] = {}

# Lock-free mirror for hot-path reads (the per-op seam checks
# FAST.check_nan_inf on every op): plain attribute assignment and read
# are atomic under the GIL, so readers never take _lock.
FAST = types.SimpleNamespace()


def _mirror(name, value):
    if name.startswith("FLAGS_"):
        setattr(FAST, name[len("FLAGS_"):], value)


def define_flag(name, default, typ=None, help=""):
    typ = typ or type(default)
    env = os.environ.get(name)
    value = default
    if env is not None:
        value = _parse(env, typ)
    with _lock:
        _registry[name] = {"value": value, "default": default, "type": typ,
                           "help": help}
    _mirror(name, value)
    return value


def _parse(s, typ):
    if typ is bool:
        return s.lower() in ("1", "true", "yes", "on")
    return typ(s)


def set_flags(flags: dict):
    with _lock:
        for k, v in flags.items():
            if k not in _registry:
                _registry[k] = {"value": v, "default": v, "type": type(v),
                                "help": ""}
            else:
                _registry[k]["value"] = _parse(str(v), _registry[k]["type"]) \
                    if isinstance(v, str) else v
            _mirror(k, _registry[k]["value"])


def get_flags(flags):
    single = isinstance(flags, str)
    names = [flags] if single else list(flags)
    out = {}
    with _lock:
        for n in names:
            if n in _registry:
                out[n] = _registry[n]["value"]
            else:
                raise ValueError(f"unknown flag {n}")
    return out


def get_flag(name, default=None):
    with _lock:
        if name in _registry:
            return _registry[name]["value"]
    return default


# the flag the port reads (the reference's others configure its XLA
# runtime and per-op executable cache, which the port has not)
define_flag("FLAGS_check_nan_inf", False, bool,
            "scan op outputs and train-step gradients for nan/inf")
