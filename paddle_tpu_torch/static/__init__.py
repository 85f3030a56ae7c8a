"""paddle.static (counterpart: ``paddle_tpu/static/__init__.py``; upstream
``python/paddle/static/``): lazy graph Variables in place of a
ProgramDesc. ``static.data`` returns a placeholder, every torch call on
one records a node, and ``Executor.run`` evaluates the fetched subgraph
(``executor.py``). ``to_static`` with ``jit.save`` remains the
recommended graph path."""
from __future__ import annotations

from ..jit.api import InputSpec
from . import nn
from .executor import Executor, Variable, data, gradients as _gradients

__all__ = ["InputSpec", "nn", "Program", "default_main_program",
           "default_startup_program", "program_guard", "Executor", "data",
           "name_scope", "py_func", "save_inference_model",
           "load_inference_model", "gradients", "Variable"]


class Program:
    def __init__(self):
        self._ops = []

    def global_block(self):
        return self

    def clone(self, for_test=False):
        return self


_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


class program_guard:
    def __init__(self, main_program=None, startup_program=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class name_scope:
    def __init__(self, prefix=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    raise NotImplementedError("static py_func is not supported; use eager mode")


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    raise NotImplementedError("use paddle.jit.save")


def load_inference_model(path_prefix, executor=None, **kwargs):
    from ..jit.api import load as jit_load
    return jit_load(path_prefix, **kwargs)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Static Variables -> gradient Variables (``executor.py``); eager
    tensors -> ``paddle.grad``."""
    from .executor import is_static_var
    tgt = targets if isinstance(targets, (list, tuple)) else [targets]
    if any(is_static_var(t) for t in tgt):
        return _gradients(targets, inputs, target_gradients)
    from ..autograd import grad
    return grad(targets, inputs, target_gradients)
