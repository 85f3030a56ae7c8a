"""Device places (counterpart: ``paddle_tpu/framework/place.py``).

The accelerator is ``CUDAPlace`` (the reference's ``TPUPlace``):
``paddle.set_device("gpu")``, ``"gpu:1"`` or ``"cuda:1"`` and
``CUDAPlace(i)`` map to ``torch.device("cuda", i)``; ``XPUPlace``,
``IPUPlace`` and ``CustomPlace`` are accepted as its aliases, so that
reference scripts run unmodified.

The device rule: with no ``set_device`` call the current place is
``CUDAPlace(0)``. Creation ops and ``to_tensor`` given no place land
there, and without a card they raise a RuntimeError that names
``paddle.set_device("cpu")`` and ``place=paddle.CPUPlace()``; nothing
slides onto the CPU on its own. ``get_device()`` and the
``is_compiled_with_*`` queries only report.
"""
from __future__ import annotations

import torch


class Place:
    """Base place: identifies a physical device."""

    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "Place(cpu)"

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch places tensors on a CUDA card by default "
                "and none is available; call paddle.set_device(\"cpu\") or "
                "pass place=paddle.CPUPlace() to run on the CPU")
        return torch.device("cuda", self.device_id)


class XPUPlace(CUDAPlace):
    """Alias: reference XPU scripts land on the card."""


class IPUPlace(CUDAPlace):
    """Alias: reference IPU scripts land on the card."""


class CustomPlace(CUDAPlace):
    """``paddle.CustomPlace(dev_type, id)``: lands on the card; the device
    type string is kept for repr parity."""

    def __init__(self, device_type: str = "gpu", device_id: int = 0):
        super().__init__(device_id)
        self.custom_device_type = str(device_type)


class CUDAPinnedPlace(CPUPlace):
    pass


_current_place: Place | None = None


def _get_place() -> Place:
    return CUDAPlace(0) if _current_place is None else _current_place


def current_device() -> torch.device:
    """The torch device of the current place (raises without a card while
    the place is the default ``CUDAPlace(0)``)."""
    return _get_place().torch_device()


def place_of(device) -> Place:
    """A Place for a device spelling: a Place, "cpu", "gpu", "gpu:1",
    "cuda:1", a ``torch.device``."""
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return CPUPlace() if device.type == "cpu" else CUDAPlace(
            device.index or 0)
    s = str(device).lower()
    kind, _, idx = s.partition(":")
    if kind == "cpu":
        return CPUPlace()
    if kind in ("gpu", "cuda", "tpu", "xpu", "npu", "ipu"):
        return CUDAPlace(int(idx) if idx else 0)
    raise ValueError(f"unknown device {device!r}")


def get_device() -> str:
    p = _get_place()
    return "cpu" if p.device_type == "cpu" else f"gpu:{p.device_id}"


def set_device(device) -> Place:
    """paddle.set_device("gpu") / "gpu:1" / "cpu" (also "cuda:1", and
    "tpu" as an alias of the card)."""
    global _current_place
    _current_place = place_of(device)
    return _current_place


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_tpu() -> bool:
    return False


# the remaining backend probes mirror the upstream surface so reference
# capability checks run unmodified; none of these backends exist here
def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_custom_device(device_type: str) -> bool:
    return False


def device_count() -> int:
    return torch.cuda.device_count()
