"""The op registry over ``op_table.py`` (counterpart:
``paddle_tpu/ops/registry.py``): ``registered_ops()`` and
``excluded_ops()`` by name, the dtype tolerance policy, and the
generated API functions of the ``unary``, ``binary``, ``compare1`` and
``compare`` families, each dispatched through the per-op seam
(``ops/dispatch.py``) so that amp and the paddle Tensor boundary apply.
Gradients come from PyTorch's autograd over the impl expression."""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .op_table import TABLE

_EXPR_NS = {"torch": torch}


def _hh_q(a, tau, full=False):
    """Householder reflectors accumulated into Q = H_1 ... H_k in float64
    (LAPACK's orgqr: v_i = e_i + a[i+1:, i])."""
    m, n = a.shape
    q = np.eye(m)
    for i in range(len(tau)):
        w = np.zeros(m)
        w[i] = 1.0
        w[i + 1:] = a[i + 1:, i]
        q = q @ (np.eye(m) - float(tau[i]) * np.outer(w, w))
    return (q if full else q[:, :n]).astype(a.dtype)


def _scipy_expm(x):
    import scipy.linalg as sla
    return sla.expm(x).astype(x.dtype)


def _block_diag_ref(*xs):
    import scipy.linalg as sla
    return sla.block_diag(*xs).astype(xs[0].dtype)


def _lu_p_ref(x):
    import scipy.linalg as sla
    return sla.lu(x)[0].astype(x.dtype)


def _mode_ref(x):
    # the smallest value wins ties, as bincount().argmax() picks
    return np.apply_along_axis(
        lambda r: np.bincount(r.astype(np.int64)).argmax(), 1, x
    ).astype(x.dtype)


# the NumPy references' namespace: independent float64 NumPy/SciPy math
_REF_NS = {"np": np, "hh_q": _hh_q,
           "hh_q_full": lambda a, tau: _hh_q(a, tau, full=True),
           "scipy_expm": _scipy_expm, "block_diag_ref": _block_diag_ref,
           "lu_p_ref": _lu_p_ref, "mode_ref": _mode_ref}

# the reference's dtype-aware tolerance policy: an entry with no atol/rtol
# of its own is held at its dtype's row
DTYPE_TOLERANCES = {
    "float64": {"atol": 1e-10, "rtol": 1e-10},
    "float32": {"atol": 1e-5, "rtol": 1e-5},
    "bfloat16": {"atol": 2e-2, "rtol": 2e-2},
    "float16": {"atol": 2e-3, "rtol": 2e-3},
}


def tolerances_for(spec, dtype_name="float32"):
    """(atol, rtol) for running ``spec`` at ``dtype_name``: the entry's
    own atol/rtol at float32/float64, the larger of the policy row and
    the entry's at the 16-bit dtypes."""
    base = DTYPE_TOLERANCES.get(dtype_name, DTYPE_TOLERANCES["float32"])
    low = dtype_name in ("bfloat16", "float16")

    def pick(key, own):
        if own is None:
            return base[key]
        return max(base[key], own) if low else own
    return pick("atol", spec.atol), pick("rtol", spec.rtol)


@dataclass
class OpSpec:
    name: str
    expr: str | None = None
    gen: str | None = None
    grad: object = False
    domain: str = "real"
    domain2: str | None = None
    ref: str | None = None
    call: str | None = None
    shapes: list = field(default_factory=lambda: [[3, 4]])
    atol: float | None = None
    rtol: float | None = None
    n_in: int = 1

    def impl(self):
        if self.expr is None:
            raise ValueError(f"op {self.name} has no generated impl")
        return _compile(self.expr, self.n_in)

    def ref_fn(self):
        if self.ref is None:
            return None
        args = "x" if self.n_in == 1 else "x, y"
        return eval(f"lambda {args}: {self.ref}", dict(_REF_NS))


@functools.lru_cache(maxsize=None)
def _compile(expr, n_in):
    args = "x" if n_in == 1 else "x, y"
    return eval(f"lambda {args}: {expr}", dict(_EXPR_NS))


@functools.lru_cache(maxsize=1)
def _load():
    registry, excluded = {}, {}
    for name, entry in TABLE:
        if "exclude" in entry:
            excluded[name] = entry["exclude"]
            continue
        spec = OpSpec(name=name, **entry)
        if spec.gen in ("binary", "compare"):
            spec.n_in = 2
        registry[name] = spec
    return registry, excluded


def registered_ops():
    """name -> OpSpec for every entry the sweep runs."""
    return dict(_load()[0])


def excluded_ops():
    """name -> reason for every export scoped out of the sweep."""
    return dict(_load()[1])


def get_op_info(name):
    return _load()[0][name]


def _gen_unary(spec, never_diff):
    from .common import ensure_tensor
    from .dispatch import dispatch, nondiff
    op_name, impl = spec.name, spec.impl()
    run = nondiff if never_diff else dispatch

    def op(x, name=None):
        return run(op_name, impl, ensure_tensor(x))
    op.__name__ = op_name
    op.__doc__ = f"Generated from the op table: ``{spec.expr}``."
    return op


def _gen_binary(spec, never_diff):
    from .common import binary_args
    from .dispatch import dispatch, nondiff
    op_name, impl = spec.name, spec.impl()
    run = nondiff if never_diff else dispatch

    def op(x, y, name=None):
        if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)):
            # torch operands keep torch's own promotion (the models' path)
            x, y = binary_args(x, y)
        return run(op_name, impl, x, y)
    op.__name__ = op_name
    op.__doc__ = f"Generated from the op table: ``{spec.expr}``."
    return op


def generate_ops(family, names=None):
    """The API functions of every ``gen: <family>`` entry (``names``
    restricts them to a subset, so each lands in its family's module)."""
    out = {}
    for spec in _load()[0].values():
        if spec.gen != family or (names is not None
                                  and spec.name not in names):
            continue
        if family in ("unary", "compare1"):
            out[spec.name] = _gen_unary(spec, family == "compare1")
        else:
            out[spec.name] = _gen_binary(spec, family == "compare")
    return out
