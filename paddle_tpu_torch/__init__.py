"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port grows slice by slice beside the JAX package, which stays the
reference it is held against. It imports ``torch`` and never ``jax``,
and nothing of ``paddle_tpu``. Module paths follow the JAX package where
that helps a reader find the counterpart (``text/gpt.py``,
``inference/serving/engine.py``, ``nn/functional/attention.py``); the
TPU kernels are rewritten by hand for Hopper under ``csrc/`` and bound
in ``ops/cuda_kernels.py``.

The device rule: entry points default to ``"cuda"``. Without a card they
raise unless the caller passed ``device="cpu"``; nothing slides onto the
CPU on its own. No 64-bit mode exists here: integer indices the kernels
read are int32.
"""
from __future__ import annotations

import torch

from .utils.flags import get_flags, set_flags

__version__ = "0.1.0"


def default_device():
    """``torch.device("cuda")``, or a RuntimeError naming ``device="cpu"``
    when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` when given (a CUDA
    device still needs a card), else ``default_device()``."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda":
        default_device()
    return device


__all__ = ["__version__", "default_device", "resolve_device", "get_flags",
           "set_flags"]


# the paddle.* eager surface: dtypes, places, the random state, Tensor,
# the op library (hoisted from ops/ into this namespace and attached as
# Tensor methods) and the autograd API
from .framework import (  # noqa: E402
    DType, bfloat16, float16, float32, float64, int8, int16, int32, int64,
    uint8, bool_ as bool, complex64, complex128, set_default_dtype,
    get_default_dtype, seed, get_rng_state, set_rng_state)
from .framework.dtype import iinfo, finfo  # noqa: E402
from .framework.random import (  # noqa: E402
    get_cuda_rng_state, set_cuda_rng_state)
from .framework.place import (  # noqa: E402
    CPUPlace, XPUPlace, CUDAPlace, CUDAPinnedPlace, IPUPlace, CustomPlace,
    set_device, get_device, is_compiled_with_cuda, is_compiled_with_xpu,
    is_compiled_with_tpu, is_compiled_with_cinn, is_compiled_with_rocm,
    is_compiled_with_ipu, is_compiled_with_custom_device, device_count)
from .tensor import Tensor, Parameter, to_tensor, create_parameter  # noqa: E402,E501
from . import tensor_methods as _tensor_methods  # noqa: E402,F401
from .ops import collect_public_ops as _collect_public_ops  # noqa: E402
from .autograd import (no_grad, enable_grad, set_grad_enabled,  # noqa: E402
                       is_grad_enabled, grad, PyLayer)

_g = globals()
for _name, _fn in _collect_public_ops().items():
    _g.setdefault(_name, _fn)
del _g, _name, _fn

from . import amp, autograd, nn, optimizer  # noqa: E402
# checkpoints, the data pipeline and the high-level API, where the
# reference exports them
from .framework.io import save, load  # noqa: E402
from . import io, metric, utils  # noqa: E402
from .hapi import Model, summary, flops, callbacks  # noqa: E402
# the data-parallel plane
from . import distributed  # noqa: E402
from .distributed import DataParallel  # noqa: E402
# the graph and deployment path: dy2static, jit.to_static/save/load,
# paddle.static's lazy graph and Executor, paddle.inference's predictor
from . import jit, static, inference  # noqa: E402
# paddle.profiler: host annotations, CUPTI device events, one timeline
from . import profiler  # noqa: E402
from .jit.api import (enable_static, disable_static,  # noqa: E402
                      in_dynamic_mode)
