"""The fleet executor (counterpart: ``paddle_tpu/distributed/
fleet_executor.py``): not ported yet. Each of the reference's names
raises on access, naming ROADMAP A7."""
from __future__ import annotations

_NAMES = ("TaskNode", "Interceptor", "Carrier", "FleetExecutor")


def __getattr__(name):
    if name in _NAMES:
        raise NotImplementedError(
            f"fleet_executor.{name} is not ported yet (ROADMAP A7)")
    raise AttributeError(name)
