"""Inference surfaces of the port: ``Config`` and ``create_predictor``
(counterpart: ``paddle_tpu/inference/__init__.py``; upstream
``paddle/fluid/inference/api/`` AnalysisPredictor), and ``serving`` (the
paged-KV serving engine).

The predictor serves ``jit.save``'s artifact (``path.pdmodel`` and
``path.pdiparams``) on the card unless ``Config.disable_gpu()`` asks for
the CPU; without a card it raises rather than running on the CPU. The
reference serves its artifact as a cached XLA executable; on CUDA the
port captures one CUDA graph per input signature
(``serving.compile_cache.capture``), holds its replay bit-equal to the
uncaptured call once (``check``), and replays it from then on, adding the
kernels the graph holds to their launch counts at each replay. On the CPU
it runs the loaded program. The Config knobs that select pass pipelines
(IR optimization, memory optimization, TensorRT, threads) are recorded
and have no separate effect, as in the reference.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from . import serving

__all__ = ["Config", "create_predictor", "Predictor", "Tensor",
           "PrecisionType", "PlaceType", "serving"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM = 3


class Config:
    """paddle_infer.Config: where the model lives and how to run it. The
    card by default; ``disable_gpu()`` for the CPU."""

    def __init__(self, prog_file=None, params_file=None):
        if prog_file is not None and params_file is None and \
                not prog_file.endswith(".pdmodel"):
            # directory form: Config("/path/to/model_dir")
            cand = [f for f in (os.listdir(prog_file)
                                if os.path.isdir(prog_file) else [])
                    if f.endswith(".pdmodel")]
            if cand:
                prog_file = os.path.join(prog_file, cand[0])
        self._prog_file = prog_file
        self._params_file = params_file
        self._use_device = "gpu"
        self._device_id = 0
        self._memory_optim = True
        self._ir_optim = True
        self._cpu_threads = 1
        self._precision = PrecisionType.Float32
        self._tensorrt = None

    # -- model location ------------------------------------------------------
    def set_prog_file(self, path):
        self._prog_file = path

    def set_params_file(self, path):
        self._params_file = path

    def set_model(self, prog_file, params_file=None):
        self._prog_file = prog_file
        self._params_file = params_file

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    def model_prefix(self):
        p = self._prog_file or ""
        return p[:-len(".pdmodel")] if p.endswith(".pdmodel") else p

    # -- device and the recorded knobs ---------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32):
        self._use_device = "gpu"
        self._device_id = device_id
        self._precision = precision

    def disable_gpu(self):
        self._use_device = "cpu"

    def enable_custom_device(self, device_type, device_id=0):
        self._use_device = device_type
        self._device_id = device_id

    def use_gpu(self):
        return self._use_device == "gpu"

    def enable_memory_optim(self, flag=True):
        self._memory_optim = flag

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_threads = n

    def enable_tensorrt_engine(self, *args, **kwargs):
        self._tensorrt = (args, kwargs)   # recorded: no TensorRT here

    def summary(self):
        return (f"Config(prog={self._prog_file}, params={self._params_file},"
                f" device={self._use_device})")

    def _torch_device(self):
        if self._use_device == "cpu":
            return torch.device("cpu")
        if self._use_device != "gpu":
            raise ValueError(f"device {self._use_device!r} is not "
                             "supported by the port's predictor")
        return torch.device("cuda", self._device_id)


class Tensor:
    """An input or output handle (paddle_infer.Tensor): a named slot on
    the predictor with copy_from_cpu / copy_to_cpu."""

    def __init__(self, name, predictor, is_input):
        self._name = name
        self._pred = predictor
        self._is_input = is_input

    def name(self):
        return self._name

    def reshape(self, shape):
        pass  # shapes flow from copy_from_cpu; a new one is a new program

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise RuntimeError("copy_from_cpu on an output handle")
        t = arr if isinstance(arr, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(arr))
        self._pred._inputs[self._name] = t.to(self._pred.device)

    def copy_to_cpu(self):
        """A NumPy copy; NumPy has no bfloat16, so a bf16 output comes back
        as float32 (exact), as ``Tensor.numpy`` gives it."""
        store = self._pred._inputs if self._is_input else \
            self._pred._outputs
        t = store[self._name].detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def shape(self):
        store = self._pred._inputs if self._is_input else \
            self._pred._outputs
        v = store.get(self._name)
        return list(v.shape) if v is not None else None


class Predictor:
    """Named input handles -> ``run()`` -> named outputs, over the loaded
    program (module doc). ``graphs`` holds the CUDA graph of each input
    signature."""

    def __init__(self, config):
        from ..jit.api import load as jit_load
        self.config = config
        self.device = config._torch_device()
        prefix = config.model_prefix()
        self._layer = jit_load(prefix, device=self.device)
        with open(prefix + ".pdiparams", "rb") as f:
            blob = pickle.load(f)
        self._specs = blob.get("specs", [])
        self._input_names = [f"x{i}" for i in range(len(self._specs))] \
            or ["x0"]
        self._inputs = {}
        self._outputs = {}
        self._output_names = []
        self.graphs = {}

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name):
        if name not in self._input_names:
            raise KeyError(f"unknown input '{name}'; "
                           f"inputs: {self._input_names}")
        return Tensor(name, self, is_input=True)

    def get_input_tensor(self, name):
        return self.get_input_handle(name)

    def _call(self, args):
        if self.device.type != "cuda":
            return self._layer.run(*args)
        from .serving import compile_cache
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        graph = self.graphs.get(key)
        if graph is None:
            static = [a.clone() for a in args]
            graph = compile_cache.capture(self._layer.run, static,
                                          "inference program")
            compile_cache.check(self._layer.run, static, graph)
            self.graphs[key] = graph
        return graph(*args)

    def run(self, inputs=None):
        """Execute: either positional ``inputs`` (arrays or tensors) or the
        handles filled through copy_from_cpu. With ``inputs`` it returns
        the outputs as NumPy arrays, else True."""
        if inputs is not None:
            args = [(a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))).to(self.device) for a in inputs]
        else:
            missing = [n for n in self._input_names
                       if n not in self._inputs]
            if missing:
                raise RuntimeError(f"inputs not set: {missing}")
            args = [self._inputs[n] for n in self._input_names]
        out = self._call(args)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        self._output_names = [f"out{i}" for i in range(len(outs))]
        self._outputs = dict(zip(self._output_names, outs))
        if inputs is not None:
            return [Tensor(n, self, False).copy_to_cpu()
                    for n in self._output_names]
        return True

    def get_output_names(self):
        return list(self._output_names) or ["out0"]

    def get_output_handle(self, name):
        return Tensor(name, self, is_input=False)

    def get_output_tensor(self, name):
        return self.get_output_handle(name)

    def clear_intermediate_tensor(self):
        self._inputs.clear()
        self._outputs.clear()


def create_predictor(config):
    return Predictor(config)
