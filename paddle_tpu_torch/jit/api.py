"""paddle.jit's public API: ``to_static``, ``save``, ``load`` (counterpart:
``paddle_tpu/jit/api.py``; upstream ``python/paddle/jit/api.py``).

``jit.save`` writes the reference's two files:

- ``path.pdmodel``: the inference program, ``torch.export.save`` of a
  non-strict ``torch.export.export`` capture (``jit/trace.py``) whose
  inputs are the parameters, the buffers and the ``input_spec`` tensors
  (a ``None`` or -1 dimension exported at 1, as the reference's
  ``InputSpec._example`` does); it holds no weights;
- ``path.pdiparams``: a pickle of NumPy arrays under the reference's keys
  ``params``, ``buffers`` and ``specs`` (bfloat16 arrays as their int16
  bits, their dtypes under ``dtypes``).

Attention in the program is the op ``paddle_tpu_torch::flash_fwd``,
which launches K2 on CUDA tensors. ``jit.load`` puts the program on the
card by default (``device="cpu"`` for the CPU; without a card and without
that, it raises): a program saved on the CPU is moved there by
``torch.export.passes.move_to_device_pass``. The reference also writes a
native bundle (StableHLO, a call signature and raw state) for its C++
loader; the port's counterpart, a libtorch or AOTInductor loader, is not
written (ROADMAP A10), and ``jit.save`` writes no such files.
"""
from __future__ import annotations

import functools
import io
import os
import pickle

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..tensor import Tensor
from .trace import TracedFunction, _collect_state, capture, run_program

_static_mode = False


def enable_static():
    global _static_mode
    _static_mode = True


def disable_static():
    global _static_mode
    _static_mode = False


def in_dynamic_mode():
    return not _static_mode


def in_dygraph_mode():
    return not _static_mode


def in_dynamic_or_pir_mode():
    # no PIR program translator here: this is the dynamic-mode probe under
    # the upstream name, as in the reference
    return not _static_mode


class InputSpec:
    """paddle.static.InputSpec (upstream ``python/paddle/static/input.py``)."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = dtype_mod.to_paddle_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"

    @classmethod
    def from_tensor(cls, tensor, name=None):
        v = tensor._value if isinstance(tensor, Tensor) else tensor
        return cls(list(v.shape), v.dtype, name)

    def _example(self, batch=1, device="cpu"):
        shape = [batch if (s is None or s == -1) else s for s in self.shape]
        return torch.zeros(shape, dtype=self.dtype.torch_dtype,
                           device=device)


class StaticFunction:
    """Result of ``@to_static`` on a Layer method or a function."""

    def __init__(self, function, input_spec=None, layer=None):
        self._function = function
        self._input_spec = input_spec
        self._layer = layer
        self._traced = None

    def _get_traced(self):
        if self._traced is None:
            from .dy2static import convert_to_static
            layers = [self._layer] if self._layer is not None else []
            base = self._function
            # dy2static: AST-convert Python if/while on tensors into the
            # cond/while_loop ops before capture; the graph-break fallback
            # is the original function (reason on __pd_graph_break__)
            converted = convert_to_static(
                base.__func__ if hasattr(base, "__func__") else base)
            if hasattr(base, "__self__"):
                fn = functools.partial(converted, base.__self__)
                if isinstance(base.__self__, torch.nn.Module):
                    layers = [base.__self__]
            elif self._layer is not None:
                fn = functools.partial(converted, self._layer)
            else:
                fn = converted
            self._traced = TracedFunction(fn, layers)
        return self._traced

    def __call__(self, *args, **kwargs):
        return self._get_traced()(*args, **kwargs)

    @property
    def concrete_program(self):
        return self._get_traced()


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """A Layer's forward, or a function, captured per input signature
    (``jit/trace.py``) after the dy2static pass. On a Layer it returns the
    layer itself, whose calls then run the captured program."""
    from ..nn.layer.layers import Layer

    def decorate(obj):
        if isinstance(obj, Layer):
            from .dy2static import convert_to_static
            conv = convert_to_static(type(obj).forward)
            traced = TracedFunction(functools.partial(conv, obj), [obj])
            obj._static_forward = traced
            obj._input_spec = input_spec
            obj.forward = traced
            return obj
        return StaticFunction(obj, input_spec)

    if function is not None:
        return decorate(function)
    return decorate


def _resolve_specs(input_spec):
    if input_spec is None:
        raise ValueError("jit.save needs input_spec (or call the layer once "
                         "and pass example tensors)")
    out = []
    for spec in input_spec:
        if isinstance(spec, InputSpec):
            out.append(spec)
        elif isinstance(spec, (Tensor, torch.Tensor)):
            out.append(InputSpec.from_tensor(spec))
        else:
            raise TypeError(f"bad input spec {spec!r}")
    return out


def _host_array(t):
    """(NumPy array, dtype name): bfloat16 as its int16 bits."""
    t = t.detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def _from_host(a, name, device):
    t = torch.from_numpy(np.ascontiguousarray(a))
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _layer_device(layer):
    for t in list(layer.parameters()) + list(layer.buffers()):
        return t.device
    return torch.device("cpu")


def save(layer, path, input_spec=None, **configs):
    """Write ``path.pdmodel`` (the inference program) and
    ``path.pdiparams`` (the state) of ``layer`` in eval mode, captured at
    ``input_spec`` on the layer's device (module doc). A layer given to
    ``to_static`` is saved through its converted forward."""
    from ..nn.layer.layers import Layer

    if not isinstance(layer, Layer):
        raise TypeError("jit.save expects a Layer")
    specs = _resolve_specs(input_spec)
    static = getattr(layer, "_static_forward", None)
    fn = static.fn if static is not None else layer.forward
    device = _layer_device(layer)
    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad():
            ep, out_kinds = capture(
                fn, [layer], [s._example(device=device) for s in specs], {})
    finally:
        if was_training:
            layer.train()
    params, buffers = _collect_state([layer])
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    with open(path + ".pdmodel", "wb") as f:
        f.write(buf.getvalue())
    p_host = [_host_array(p) for p in params]
    b_host = [_host_array(b) for b in buffers]
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({
            "params": [a for a, _ in p_host],
            "buffers": [a for a, _ in b_host],
            "specs": [(s.shape, s.dtype.name) for s in specs],
            "dtypes": {"params": [n for _, n in p_host],
                       "buffers": [n for _, n in b_host]},
        }, f)


class TranslatedLayer:
    """A loaded inference program (upstream ``TranslatedLayer``): called
    with tensors or arrays, it runs the program on its device and returns
    paddle Tensors (torch tensors when it was given torch tensors only)."""

    def __init__(self, program, params, buffers, specs, device):
        self._program = program
        self._params = params
        self._buffers = buffers
        self._specs = specs
        self.device = device
        self.training = False

    def _inputs(self, args):
        vals = []
        for a in args:
            v = a._value if isinstance(a, Tensor) else a
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            vals.append(v.to(self.device))
        return vals

    def run(self, *vals):
        """The program on torch tensors already on its device."""
        with torch.no_grad():
            return run_program(self._program, self._params, self._buffers,
                               vals, {})

    def __call__(self, *args):
        out = self.run(*self._inputs(args))
        if args and all(isinstance(a, torch.Tensor) for a in args):
            return out
        return torch.utils._pytree.tree_map(
            lambda v: Tensor._wrap(v) if isinstance(v, torch.Tensor) else v,
            out)

    forward = __call__

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only")

    def parameters(self, include_sublayers=True):
        return [Tensor._wrap(p) for p in self._params]


def _to_device(program, device):
    """The program on ``device``: ``move_to_device_pass`` moves its
    constants and tensor metadata; the device a node names in its
    arguments (a factory's ``device=``, made where the program was
    captured) is rewritten here, in every subgraph too."""
    from torch.export.passes import move_to_device_pass
    program = move_to_device_pass(program, device)

    def fix(a):
        return device if isinstance(a, torch.device) else a

    for gm in program.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            if node.op == "call_function":
                node.args = torch.utils._pytree.tree_map(fix, node.args)
                node.kwargs = torch.utils._pytree.tree_map(fix, node.kwargs)
        gm.recompile()
    return program


def load(path, device=None, **configs):
    """The program and state ``jit.save`` wrote at ``path``, on
    ``device`` (the card unless ``device="cpu"``)."""
    from .. import resolve_device
    from ..ops import cuda_kernels  # noqa: F401  (registers the K2/K3 ops)
    device = resolve_device(device)
    with open(path + ".pdmodel", "rb") as f:
        program = _to_device(torch.export.load(io.BytesIO(f.read())),
                             device)
    with open(path + ".pdiparams", "rb") as f:
        blob = pickle.load(f)
    names = blob.get("dtypes", {})
    params = [_from_host(a, n, device) for a, n in zip(
        blob["params"], names.get("params", [None] * len(blob["params"])))]
    buffers = [_from_host(a, n, device) for a, n in zip(
        blob["buffers"],
        names.get("buffers", [None] * len(blob["buffers"])))]
    return TranslatedLayer(program, params, buffers, blob["specs"], device)


def not_to_static(fn=None):
    return fn


def ignore_module(modules):
    pass
