"""Functional capture: a dygraph Layer or function -> one captured program
per input signature (counterpart: ``paddle_tpu/jit/trace.py``).

The reference re-executes the user's Python under JAX tracers and
``jax.jit`` compiles the jaxpr, re-specializing on input avals. Here the
user's Python runs under a non-strict ``torch.export.export`` (fake
tensors, no data), once per signature: the inputs' shapes, dtypes and
devices, the Python values among them, grad mode and the layers'
training flags. The program takes the parameters and buffers as inputs
(``torch.func.functional_call`` over them), as the reference's
``pure(param_vals, buffer_vals, ...)`` does, so the captured graph holds
no copy of the state: each call runs it on the layers' live parameters
and buffers. Gradients land on the live parameters (an optimizer step
is seen by the next call) and a buffer written in place (BatchNorm's
running statistics) is the live buffer.

The backward is PyTorch's autograd over the captured graph's ops: the
counterpart of ``jax.vjp`` over the reference's program; attention's
node is the op ``paddle_tpu_torch::flash_fwd``, whose backward is K3.
Dropout draws from torch's generator (the reference's ``TracedRNG`` salts
are not reproduced).
"""
from __future__ import annotations

import time

import torch
import torch.utils._pytree as pytree

from ..tensor import Tensor


def _collect_state(layers):
    """The layers' parameters and buffers, each once (tied ones under
    their first name)."""
    params, buffers = [], []
    seen = set()
    for layer in layers:
        for _, p in layer.named_parameters():
            if id(p) not in seen:
                seen.add(id(p))
                params.append(p)
        for _, b in layer.named_buffers():
            if id(b) not in seen:
                seen.add(id(b))
                buffers.append(b)
    return params, buffers


def tree_unwrap(obj):
    """paddle Tensors (in tuples, lists, dicts) as their torch tensors."""
    return pytree.tree_map(
        lambda x: x._value if isinstance(x, Tensor) else x, obj,
        is_leaf=lambda x: isinstance(x, Tensor))


def _kinds(obj):
    return [isinstance(x, Tensor) for x in pytree.tree_leaves(
        obj, is_leaf=lambda x: isinstance(x, Tensor))]


def _rewrap(obj, kinds):
    """The leaves of ``obj`` marked in ``kinds`` as paddle Tensors."""
    leaves, spec = pytree.tree_flatten(obj)
    return pytree.tree_unflatten(
        [Tensor._wrap(v) if k and isinstance(v, torch.Tensor) else v
         for v, k in zip(leaves, kinds)], spec)


class _Holder(torch.nn.Module):
    """The layers under one root, so ``functional_call`` can swap their
    parameters and buffers for the program's inputs; ``body`` runs the
    function on them."""

    def __init__(self, body, layers):
        super().__init__()
        self.layers = torch.nn.ModuleList(layers)
        self.__dict__["body"] = body

    def forward(self, args, kwargs):
        return self.body(args, kwargs)


class _Functional(torch.nn.Module):
    """forward(params, buffers, args, kwargs): the program's signature."""

    def __init__(self, holder):
        super().__init__()
        self.__dict__["holder"] = holder
        self.__dict__["names"] = (
            [n for n, _ in holder.named_parameters()],
            [n for n, _ in holder.named_buffers()])

    def forward(self, params, buffers, args, kwargs):
        pnames, bnames = self.names
        state = dict(zip(pnames, params))
        state.update(zip(bnames, buffers))
        return torch.func.functional_call(self.holder, state,
                                          (args, kwargs))


def capture(fn, layers, args, kwargs):
    """(ExportedProgram, output kinds): ``fn(*args, **kwargs)`` exported
    with the layers' state as inputs. Paddle Tensors among the inputs
    reach ``fn`` as paddle Tensors; the program's inputs and outputs are
    torch tensors, and the output kinds say which outputs ``fn`` gave as
    paddle Tensors."""
    in_kinds, out_kinds = _kinds((args, kwargs)), []

    def body(a, k):
        a, k = _rewrap((a, k), in_kinds)
        out = fn(*a, **k)
        out_kinds[:] = _kinds(out)
        return tree_unwrap(out)

    args, kwargs = tree_unwrap((args, kwargs))
    holder = _Holder(body, layers)
    params, buffers = _collect_state([holder])
    ep = torch.export.export(
        _Functional(holder),
        (tuple(params), tuple(buffers), tuple(args), dict(kwargs)),
        strict=False)
    # the program keeps no reference to the inputs (nor the state) it was
    # captured with, and jit.save writes none
    ep.example_inputs = None
    return ep, list(out_kinds)


def run_program(ep, params, buffers, args, kwargs):
    """Run the exported graph on the given state and inputs (torch
    tensors); returns the outputs in their captured structure."""
    leaves = pytree.tree_leaves(((tuple(params), tuple(buffers),
                                  tuple(args), dict(kwargs)), {}))
    by_name = {}
    inputs = []
    user = iter(leaves)
    kinds = torch.export.graph_signature.InputKind
    for spec in ep.graph_signature.input_specs:
        if spec.kind == kinds.USER_INPUT:
            v = next(user)
            by_name[spec.arg.name] = v
            inputs.append(v)
        elif spec.kind == kinds.CONSTANT_TENSOR:
            inputs.append(ep.constants[spec.target])
        elif spec.kind in (kinds.PARAMETER, kinds.BUFFER):
            inputs.append(ep.state_dict[spec.target])
        else:
            raise RuntimeError(f"captured program has an input of kind "
                               f"{spec.kind}, which this runner does not "
                               "feed")
    outs = ep.graph_module(*inputs)
    okinds = torch.export.graph_signature.OutputKind
    user_outs = []
    for spec, v in zip(ep.graph_signature.output_specs, outs):
        if spec.kind == okinds.USER_OUTPUT:
            user_outs.append(v)
        elif spec.kind == okinds.USER_INPUT_MUTATION:
            with torch.no_grad():
                by_name[spec.target].copy_(v)
        else:
            raise RuntimeError(f"captured program has an output of kind "
                               f"{spec.kind}, which this runner does not "
                               "apply")
    return pytree.tree_unflatten(user_outs, ep.call_spec.out_spec)


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), x.dtype, x.device, x.requires_grad)
    return ("c", type(x).__name__, repr(x))


class TracedFunction:
    """One program per input signature over (params, buffers, args); the
    counterpart of the reference's per-aval ``jax.jit`` cache (the
    reference's per-InputSpec ConcreteProgram cache). ``programs`` holds
    them; ``capture_seconds`` is the last capture's time."""

    def __init__(self, fn, layers):
        self.fn = fn
        self.layers = list(layers)
        self.programs = {}
        self.capture_seconds = None

    def concrete_program(self):
        return self

    def _signature(self, args, kwargs):
        leaves, spec = pytree.tree_flatten(tree_unwrap((args, kwargs)))
        training = tuple(m.training for layer in self.layers
                         for m in layer.modules())
        return (str(spec), tuple(_leaf_key(v) for v in leaves),
                torch.is_grad_enabled(), training,
                tuple(_kinds((args, kwargs))))

    def program(self, args, kwargs):
        """(ExportedProgram, output kinds) for this signature, captured on
        first use."""
        key = self._signature(args, kwargs)
        entry = self.programs.get(key)
        if entry is None:
            t0 = time.perf_counter()
            entry = capture(self.fn, self.layers, args, kwargs)
            self.capture_seconds = time.perf_counter() - t0
            self.programs[key] = entry
        return entry

    def __call__(self, *args, **kwargs):
        ep, out_kinds = self.program(args, kwargs)
        params, buffers = _collect_state(self.layers)
        args, kwargs = tree_unwrap((args, kwargs))
        out = run_program(ep, params, buffers, args, kwargs)
        return _rewrap(out, out_kinds)
