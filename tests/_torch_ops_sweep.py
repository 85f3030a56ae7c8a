"""The op sweep of the ``paddle.*`` surface, shared by the
``test_torch_ops_*`` files: every entry of the reference's op table is
paired with the port's entry of the same name; the same seeded numpy
inputs go through the reference (``paddle_tpu``) and the port
(``paddle_tpu_torch``, on the CPU) by the entry's ``call``; outputs are
held at ``tolerances_for(spec)`` (float32 inputs), and where the entry
has ``grad: true`` or ``"zero"`` so are the gradients of ``sum(out)``
(float64 inputs, as the reference's own sweep takes its gradients).
The inputs come from the port's ``ops/sweep.py``, which the card's
sweep draws from too."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.nn import functional as ref_F
from paddle_tpu.ops.registry import excluded_ops as ref_excluded
from paddle_tpu.ops.registry import registered_ops as ref_registered
from paddle_tpu_torch.framework import place as port_place
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.ops.registry import (excluded_ops, registered_ops,
                                           tolerances_for)
from paddle_tpu_torch.ops.sweep import (call_of, family, flatten, inputs,
                                        seed_of)

REF = ref_registered()
PORT = registered_ops()


def names(fam, grad=False):
    return sorted(n for n in REF if family(n) == fam
                  and (not grad or REF[n].grad in (True, "zero")))


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's current place is the CPU for the test (the default
    place is the card), and the previous one after."""
    prev = port_place._current_place
    port_place.set_device("cpu")
    yield
    port_place._current_place = prev



def _np(t):
    return np.asarray(t.numpy())


def check_pairing(name):
    """The port's entry carries the reference's metadata."""
    r, p = REF[name], PORT[name]
    for key in ("gen", "grad", "domain", "domain2", "ref", "call", "shapes",
                "atol", "rtol", "n_in"):
        assert getattr(r, key) == getattr(p, key), (name, key)


def check_output(name):
    spec = PORT[name]
    arrays = inputs(spec, seed_of(name), np.float32)
    want = flatten(call_of(ref, ref_F, REF[name])(
        *[ref.to_tensor(a) for a in arrays]))
    got = flatten(call_of(port, port_F, spec)(
        *[port.to_tensor(a) for a in arrays]))
    assert len(got) == len(want), name
    atol, rtol = tolerances_for(spec)
    for g, w in zip(got, want):
        assert isinstance(g, port.Tensor), (name, type(g))
        gn, wn = _np(g), _np(w)
        assert gn.shape == wn.shape, (name, gn.shape, wn.shape)
        assert gn.dtype == wn.dtype, (name, gn.dtype, wn.dtype)
        np.testing.assert_allclose(gn, wn, atol=atol, rtol=rtol,
                                   err_msg=name)
    ref_np = spec.ref_fn()
    if ref_np is not None:
        np.testing.assert_allclose(_np(got[0]), np.asarray(ref_np(*arrays)),
                                   atol=atol, rtol=rtol, err_msg=name)


def _grads(pkg, F, spec, arrays):
    ts = [pkg.to_tensor(a, stop_gradient=not np.issubdtype(a.dtype,
                                                           np.floating))
          for a in arrays]
    out = call_of(pkg, F, spec)(*ts)
    if isinstance(out, (list, tuple)):
        out = out[0]
    pkg.sum(out).backward()
    return [None if t.grad is None else _np(t.grad) for t in ts]


def check_grad(name):
    spec = PORT[name]
    arrays = inputs(spec, seed_of(name) + 1, np.float64)
    want = _grads(ref, ref_F, REF[name], arrays)
    got = _grads(port, port_F, spec, arrays)
    atol, rtol = tolerances_for(spec)
    for a, g, w in zip(arrays, got, want):
        if not np.issubdtype(a.dtype, np.floating):
            continue
        g = np.zeros_like(a) if g is None else g
        w = np.zeros_like(a) if w is None else w
        if spec.grad == "zero":
            assert not np.abs(g).any(), name
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)


def reference_names():
    return sorted(set(REF) | set(ref_excluded()))


def port_names():
    return sorted(set(PORT) | set(excluded_ops()))
