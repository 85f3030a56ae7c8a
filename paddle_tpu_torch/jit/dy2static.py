"""dygraph-to-static control flow (counterpart:
``paddle_tpu/jit/dy2static.py``; upstream ``python/paddle/jit/dy2static/``).

An AST pass rewrites Python ``if``/``while``/``for ... in range(...)``
into calls of the runtime converters below; the pass is the reference's,
copied (it imports nothing of JAX). The converters keep plain-Python
semantics whenever the predicate is a concrete value, and lower onto
PyTorch's structured control flow when it is traced: under a
``torch.export`` capture (``jit/trace.py``) a tensor predicate is a fake
tensor with no data, and ``bool()`` on it would raise. A fake tensor that
carries a constant (one made inside the function from Python numbers,
``paddle.to_tensor(0.0)``) is concrete, as a NumPy value is in the
reference.

- a traced ``if`` becomes the ``cond`` higher-order op (the reference's
  ``lax.cond``), a traced ``while`` (and a ``for`` over a tensor
  ``range``) the ``while_loop`` op (``lax.while_loop``);
- the branches and loop bodies read the enclosing frame's tensors
  freely; those tensors are passed to the op as operands (``_Lift``: the
  op's subgraph would otherwise hold them as constants). A branch or body
  is traced once more when it reads one the last trace did not know;
- Python numbers a branch or body produces (``break`` flags, counters)
  become 0-d tensors (bool, int64, float32), as JAX's weak types do.

Limits kept from the reference: both branches give one structure of one
shape and dtype; a traced while loop has no reverse-mode gradient (as
``lax.while_loop`` has none); ``return`` inside a converted loop, ``for``
over other iterables with traced lengths and a traced ``step`` are
``TranslateError``s, and ``convert_to_static`` then returns the original
function with the reason on ``__pd_graph_break__``. A static
``Variable`` (``paddle.static``) is no traced value here: a predicate on
one raises as a host read does.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap
import threading

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.overrides import TorchFunctionMode

from ..tensor import Tensor


class _UndefinedVar:
    """Sentinel for a variable not yet bound when a converted block runs.
    A singleton object (never a plausible user value); reaching a traced
    cond with one raises a clear error instead of a structure mismatch."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<undefined (bound in only one branch of a converted if)>"


_UNDEF = _UndefinedVar()


class TranslateError(Exception):
    """An unsupported construct inside to_static control-flow conversion."""


def _unwrap(x):
    return x._value if isinstance(x, Tensor) else x


def _wrap(v):
    return Tensor._wrap(v) if isinstance(v, torch.Tensor) else v


def _fake_constant(v):
    """(is fake, its constant or None) of a torch tensor."""
    from torch._subclasses.fake_tensor import is_fake
    if not is_fake(v):
        return False, None
    return True, getattr(v, "constant", None)


def _is_traced(x):
    """A tensor whose value is unknown until the captured program runs: a
    fake tensor of a ``torch.export`` capture without a constant."""
    v = _unwrap(x)
    if not isinstance(v, torch.Tensor):
        return False
    fake, const = _fake_constant(v)
    return fake and const is None


def _to_bool(x):
    v = _unwrap(x)
    if isinstance(v, torch.Tensor):
        fake, const = _fake_constant(v)
        return bool(const if fake else v)
    return bool(np.asarray(v))


def _any_paddle(*xs):
    return any(isinstance(x, Tensor) for x in xs)


# -- lifting the enclosing frame's tensors into a higher-order op's operands

_LIFTS = threading.local()


def _lift_stack():
    if not hasattr(_LIFTS, "stack"):
        _LIFTS.stack = []
    return _LIFTS.stack


class _FoundFree(Exception):
    def __init__(self, tensors):
        super().__init__("free tensors")
        self.tensors = tensors


class _Lift(TorchFunctionMode):
    """While a branch or loop body is traced: every tensor a torch call
    reads that the body neither made nor was given is an enclosing-frame
    tensor. A known one is replaced by the subgraph's placeholder
    (``subst``); an unknown one is collected (``found``) for the next
    trace. Only the innermost lift acts."""

    def __init__(self, subst, inner):
        super().__init__()
        self.subst = subst
        self.known = {id(t) for t in inner}
        self.found = {}

    def fix(self, t):
        if isinstance(t, torch.Tensor):
            s = self.subst.get(id(t))
            if s is not None:
                return s
            if id(t) not in self.known:
                self.found[id(t)] = t
        return t

    def note(self, out):
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.known.add(id(t))
        return out

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _lift_stack()[-1] is not self:
            return func(*args, **kwargs)
        args, kwargs = pytree.tree_map(self.fix, (args, kwargs))
        return self.note(func(*args, **kwargs))


def _subgraph_fn(body, lifted, n_given):
    """``body(*given)`` traced as a subgraph of a higher-order op whose
    inputs are the given tensors, then the ``lifted`` free tensors."""
    def fn(*inner):
        given, free = inner[:n_given], inner[n_given:]
        lift = _Lift({id(o): i for o, i in zip(lifted, free)}, inner)
        stack = _lift_stack()
        stack.append(lift)
        try:
            with lift:
                outs = body(*given)
            outs = tuple(lift.fix(o) for o in outs)
        finally:
            stack.pop()
        if lift.found:
            raise _FoundFree(list(lift.found.values()))
        # a subgraph's output may not alias its input
        ids = {id(t) for t in inner}
        return tuple(o.clone() if id(o) in ids or o._base is not None else o
                     for o in outs)
    return fn


def _call_lifted(call, bodies, given):
    """Call the higher-order op ``call(fns, operands)`` with the bodies
    as subgraph functions over ``given`` plus every free tensor they read,
    tracing again while a trace finds one it was not given."""
    outer = _lift_stack()[-1] if _lift_stack() else None
    lifted = []
    while True:
        fns = [_subgraph_fn(b, lifted, len(given)) for b in bodies]
        operands = list(given) + lifted
        if outer is not None:
            operands = [outer.fix(t) for t in operands]
        try:
            out = call(fns, tuple(operands))
        except _FoundFree as e:
            seen = {id(t) for t in lifted}
            lifted += [t for t in e.tensors if id(t) not in seen]
            continue
        return out if outer is None else outer.note(out)


def _as_leaf_tensor(v, device, name):
    """A branch or body output as a tensor: Python bools, ints and floats
    become 0-d bool, int64 and float32 tensors."""
    v = _unwrap(v)
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, _UndefinedVar):
        raise RuntimeError(
            f"dy2static: variable '{name}' is bound in only one branch of a "
            "tensor-predicate `if`; bind it before the if (or in both "
            "branches) so the cond op sees matching structures")
    if isinstance(v, (bool, np.bool_)):
        return torch.full((), bool(v), dtype=torch.bool, device=device)
    if isinstance(v, (int, np.integer)):
        return torch.full((), int(v), dtype=torch.int64, device=device)
    if isinstance(v, (float, np.floating)):
        return torch.full((), float(v), dtype=torch.float32, device=device)
    raise TypeError(f"dy2static: '{name}' ({type(v).__name__}) is not a "
                    "tensor or a Python number; a traced branch or loop "
                    "carries tensors only")


def _flat(tree, device, names=None):
    """(tensor leaves, spec, kinds, constants) of a branch's output: None
    leaves stay Python constants, the rest become tensors; ``kinds``
    records which leaves were paddle Tensors."""
    leaves, spec = pytree.tree_flatten(tree)
    tensors, kinds, consts = [], [], []
    for i, v in enumerate(leaves):
        if v is None:
            consts.append(i)
            continue
        name = names[i] if names and i < len(names) else f"output {i}"
        tensors.append(_as_leaf_tensor(v, device, name))
        kinds.append(isinstance(v, Tensor))
    return tensors, spec, kinds, consts


def _rebuild(outs, spec, kinds, consts, paddle):
    outs = iter(outs)
    kinds = iter(kinds)
    leaves = []
    for i in range(spec.num_leaves):
        if i in consts:
            leaves.append(None)
            continue
        o, k = next(outs), next(kinds)
        leaves.append(Tensor._wrap(o) if (k or paddle) else o)
    return pytree.tree_unflatten(leaves, spec)


def _pred_tensor(pred):
    p = _unwrap(pred).reshape(())
    return p if p.dtype == torch.bool else p != 0


def _traced_cond(pred, true_fn, false_fn, names=None):
    """The cond op over two zero-argument branches returning one pytree
    structure (leaves tensors, Python numbers or None)."""
    from torch._higher_order_ops.cond import cond_op
    p = _pred_tensor(pred)
    meta = {}

    def branch(fn, key):
        def body():
            tensors, spec, kinds, consts = _flat(fn(), p.device, names)
            meta[key] = (spec, kinds, consts)
            return tuple(tensors)
        return body

    out = _call_lifted(
        lambda fns, ops: cond_op(p, fns[0], fns[1], ops),
        [branch(true_fn, True), branch(false_fn, False)], ())
    (ts, tk, tc), (fs, fk, fc) = meta[True], meta[False]
    if ts != fs or tc != fc:
        raise RuntimeError(
            "dy2static: the branches of a tensor-predicate `if` return "
            f"different structures ({ts} against {fs})")
    kinds = [a or b for a, b in zip(tk, fk)]
    return _rebuild(out, ts, kinds, tc, isinstance(pred, Tensor))


def convert_ifelse(pred, true_fn, false_fn, operands=(), names=()):
    """Runtime dispatch for a converted ``if``: the cond op when the
    predicate is traced, plain Python branching otherwise. Both branch
    fns take the current values of every variable assigned in either
    branch (the reference's get_args/set_args pattern: parameters, not
    closures, so assign-then-read inside a branch works) and return their
    final values as a tuple."""
    if _is_traced(pred):
        return tuple(_traced_cond(pred, lambda: tuple(true_fn(*operands)),
                                  lambda: tuple(false_fn(*operands)),
                                  names))
    taken = true_fn if _to_bool(pred) else false_fn
    return taken(*operands)


def convert_while(cond_fn, body_fn, loop_vars):
    """Runtime dispatch for a converted ``while``: the while_loop op when
    the condition on the initial vars is traced, else a plain Python
    loop."""
    first = cond_fn(*loop_vars)
    if _is_traced(first):
        return _traced_while(cond_fn, body_fn, loop_vars, first)
    vs = tuple(loop_vars)
    while _to_bool(cond_fn(*vs)):
        vs = tuple(body_fn(*vs))
    return vs


def _traced_while(cond_fn, body_fn, loop_vars, first):
    """The while_loop op over the loop variables (Python numbers become
    0-d tensors on the traced condition's device)."""
    from torch._higher_order_ops.while_loop import while_loop_op
    paddle = _any_paddle(first, *loop_vars)
    device = _unwrap(first).device
    kinds = [isinstance(v, Tensor) for v in loop_vars]
    init = [_as_leaf_tensor(v, device, f"loop variable {i}").contiguous()
            for i, v in enumerate(loop_vars)]
    n = len(init)

    def wrap(vs):
        return [Tensor._wrap(v) if (k or paddle) else v
                for v, k in zip(vs, kinds)]

    def c(*vs):
        return (_pred_tensor(cond_fn(*wrap(vs))),)

    def b(*vs):
        out = body_fn(*wrap(vs))
        return tuple(_as_leaf_tensor(o, device, f"loop variable {i}")
                     .to(init[i].dtype).contiguous()
                     for i, o in enumerate(out))

    def call(fns, ops):
        cfn, bfn = fns
        return while_loop_op(lambda *a: cfn(*a)[0], bfn, tuple(ops[:n]),
                             tuple(ops[n:]))

    # the carried values are the subgraphs' given inputs; what the body
    # reads besides them is lifted into additional inputs
    out = _call_lifted(call, [c, b], init)
    return tuple(wrap(out))


def convert_for_range(start, stop, step, body_fn, loop_vars):
    """Converted ``for i in range(...)``: body_fn(i, *vars) -> vars; the
    wrapper owns the index increment. Traced bounds/state lower onto
    convert_while; Python ints run a plain loop through the same path."""
    if isinstance(step, (Tensor, torch.Tensor)):
        raise TranslateError(
            "for-range step must be a python int in to_static")
    step = int(step)
    if step == 0:
        raise ValueError("range() arg 3 must not be zero")

    def cond(i, *vs):
        lhs, rhs = (i, stop) if step > 0 else (stop, i)
        if _is_traced(i) or _is_traced(stop):
            r = _unwrap(lhs) < _unwrap(rhs)
            return Tensor._wrap(r) if _any_paddle(i, stop) else r
        return bool(np.asarray(_host(lhs)) < np.asarray(_host(rhs)))

    def body(i, *vs):
        out = body_fn(i, *vs)
        nxt = Tensor._wrap(_unwrap(i) + step) if isinstance(i, Tensor) \
            else i + step
        return (nxt,) + tuple(out)

    out = convert_while(cond, body, (start,) + tuple(loop_vars))
    return (post_loop_index(out[0], start, stop, step),) + tuple(out[1:])


def _host(x):
    """A concrete value as NumPy-readable: a fake constant's constant."""
    v = _unwrap(x)
    if isinstance(v, torch.Tensor):
        fake, const = _fake_constant(v)
        return (const if fake else v).detach().cpu().numpy()
    return v


def post_loop_index(i, start, stop, step):
    """Python-parity post-loop binding for a converted for-range: the loop
    variable keeps its LAST ITERATED value (the wrapper's index minus one
    step) when at least one iteration ran (the converted body increments
    the index after every iteration, including one ended by ``break``).
    Zero-trip loops bind the target to start; Python leaves it unbound,
    which traced code cannot represent."""
    if any(_is_traced(v) for v in (i, start, stop)):
        s0, sp, iv = _unwrap(start), _unwrap(stop), _unwrap(i)
        dev = next(v.device for v in (iv, s0, sp)
                   if isinstance(v, torch.Tensor))
        ran = (s0 < sp) if step > 0 else (s0 > sp)
        ran, = _bool_tensors(ran, iv)[:1]
        s0 = s0 if isinstance(s0, torch.Tensor) else \
            torch.full((), s0, dtype=torch.int64, device=dev)
        r = torch.where(ran, iv - step, s0)
        return Tensor._wrap(r) if _any_paddle(i, start, stop) else r
    s0, sp = np.asarray(_host(start)), np.asarray(_host(stop))
    if (step > 0 and s0 < sp) or (step < 0 and s0 > sp):
        return Tensor._wrap(_unwrap(i) - step) if isinstance(i, Tensor) \
            else i - step
    return start


def _bool_tensors(*xs):
    """0-d bool tensors of tensors and Python values alike, on the
    device of the first tensor among them."""
    dev = next(_unwrap(x).device for x in xs
               if isinstance(_unwrap(x), torch.Tensor))
    out = []
    for x in xs:
        v = _unwrap(x)
        out.append(v.reshape(()).bool() if isinstance(v, torch.Tensor)
                   else torch.full((), bool(v), device=dev))
    return out


def loop_guard(brk, test):
    """not brk AND test: the loop condition under a break flag, tensor or
    Python on either side."""
    if _is_traced(brk) or _is_traced(test):
        b, t = _bool_tensors(brk, test)
        r = torch.logical_and(torch.logical_not(b), t)
        return Tensor._wrap(r) if _any_paddle(brk, test) else r
    return (not _to_bool(brk)) and _to_bool(test)


def not_escaped(brk, cont):
    """not (brk or cont): guards the rest of an iteration after a
    break/continue site."""
    if _is_traced(brk) or _is_traced(cont):
        r = torch.logical_not(torch.logical_or(*_bool_tensors(brk, cont)))
        return Tensor._wrap(r) if _any_paddle(brk, cont) else r
    return not (_to_bool(brk) or _to_bool(cont))


def convert_ifelse_value(pred, true_fn, false_fn):
    """Value-returning converted ``if`` (early-return CPS): both thunks are
    zero-arg callables (lambdas binding the enclosing frame's state into
    the parametered CPS thunks) and return the FUNCTION's return value;
    the cond op selects between the two pytrees."""
    if _is_traced(pred):
        return _traced_cond(pred, true_fn, false_fn)
    return true_fn() if _to_bool(pred) else false_fn()


# --------------------------------------------------------------- AST pass --
def _assign(name, value_node):
    return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                      value=value_node)


def _const(v):
    return ast.Constant(value=v)


def _name(n):
    return ast.Name(id=n, ctx=ast.Load())


def _call(fn_name, *args):
    return ast.Call(func=_name(fn_name), args=list(args), keywords=[])


def _contains_return(stmts):
    """True if any statement (outside nested defs/lambdas) returns."""
    class V(ast.NodeVisitor):
        found = False

        def visit_Return(self, node):
            self.found = True

        def visit_FunctionDef(self, node):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

    v = V()
    for s in stmts:
        v.visit(s)
    return v.found


def _terminal(stmts):
    return bool(stmts) and isinstance(stmts[-1], (ast.Return, ast.Raise))


def _functionalize_returns(stmts, counter):
    """Early-return CPS (SOT-lite): an ``if`` whose branches return turns
    into ``return __pd_cps_if(pred, then_thunk, else_thunk)`` where the
    remainder of the block is appended to any branch that can fall
    through. Names a thunk both READS and WRITES (e.g. ``acc = acc + 1``
    in a copied continuation) become thunk PARAMETERS — closure capture
    cannot provide the pre-if value once an assignment makes the name
    thunk-local (it would raise UnboundLocalError at trace time, since
    lax.cond traces both thunks). Read-only names still resolve through
    the closure; the call site binds each parameter from the enclosing
    frame (``locals().get``-guarded, so names first bound inside the
    continuation work too) and hands the thunks to ``__pd_cps_if`` as
    zero-arg lambdas."""
    out = []
    for idx, s in enumerate(stmts):
        if isinstance(s, ast.If) and (_contains_return(s.body)
                                      or _contains_return(s.orelse)):
            rest = stmts[idx + 1:]

            def branch(blist):
                blist = list(blist)
                if not _terminal(blist):
                    blist = blist + [ast.copy_location(
                        ast.parse(ast.unparse(r)).body[0], r)
                        for r in rest] if rest else blist
                return _functionalize_returns(blist, counter)

            counter[0] += 1
            tname = f"__pd_cps_t_{counter[0]}"
            fname = f"__pd_cps_f_{counter[0]}"
            tbody = branch(s.body) or [ast.Pass()]
            fbody = branch(s.orelse) or [ast.Pass()]

            def params_for(body):
                stored = set(_assigned_names(body))
                loaded = set()
                for st in body:
                    loaded |= _loaded_names(st)
                return sorted(n for n in stored & loaded
                              if not n.startswith("__pd_"))

            tparams, fparams = params_for(tbody), params_for(fbody)

            def thunk_def(name, params, body):
                return ast.FunctionDef(
                    name=name,
                    args=ast.arguments(
                        posonlyargs=[],
                        args=[ast.arg(arg=n) for n in params],
                        kwonlyargs=[], kw_defaults=[], defaults=[]),
                    body=body, decorator_list=[])

            def bind(name, params):
                return ast.Lambda(
                    args=_noargs(),
                    body=_call(name, *[_name(n) for n in params]))

            guards = [_undef_guard(n)
                      for n in sorted(set(tparams) | set(fparams))]
            out += [thunk_def(tname, tparams, tbody),
                    thunk_def(fname, fparams, fbody)] + guards + [
                    ast.Return(value=_call("__pd_cps_if", s.test,
                                           bind(tname, tparams),
                                           bind(fname, fparams)))]
            return out
        out.append(s)
    return out


def _rewrite_escapes(stmts, brk, cont):
    """break/continue belonging to THIS loop -> flag assignments; the rest
    of the block after a flag-setting statement runs under a
    ``if not_escaped(brk, cont):`` guard. Nested loops keep their own
    break/continue. Returns (new_stmts, used_any_flag)."""
    out = []
    used = False
    for idx, s in enumerate(stmts):
        if isinstance(s, ast.Break):
            out.append(_assign(brk, _const(True)))
            return out, True  # rest of this block is unreachable
        if isinstance(s, ast.Continue):
            out.append(_assign(cont, _const(True)))
            return out, True
        if isinstance(s, (ast.For, ast.While, ast.FunctionDef,
                          ast.AsyncFunctionDef)):
            out.append(s)
            continue
        if isinstance(s, ast.If):
            b, ub = _rewrite_escapes(s.body, brk, cont)
            o, uo = _rewrite_escapes(s.orelse, brk, cont)
            out.append(ast.If(test=s.test, body=b or [ast.Pass()],
                              orelse=o))
            if ub or uo:
                rest, _ = _rewrite_escapes(stmts[idx + 1:], brk, cont)
                if rest:
                    out.append(ast.If(
                        test=_call("__pd_not_escaped", _name(brk),
                                   _name(cont)),
                        body=rest, orelse=[]))
                return out, True
            continue
        out.append(s)
    return out, used


class _Forbidden(ast.NodeVisitor):
    def __init__(self, what):
        self.what = what

    def visit_Return(self, node):
        raise TranslateError(
            f"return inside a converted {self.what} is not supported; "
            "assign to a variable and return after the block")

    def visit_Break(self, node):
        raise TranslateError(
            f"break inside a converted {self.what} is not supported")

    def visit_Continue(self, node):
        raise TranslateError(
            f"continue inside a converted {self.what} is not supported")

    def visit_FunctionDef(self, node):
        pass  # nested defs own their control flow

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _assigned_names(stmts):
    """Names bound by a statement list (Store contexts + aug-assign +
    with/for targets), excluding nested function bodies."""
    names = []

    class V(ast.NodeVisitor):
        def visit_Name(self, node):
            if isinstance(node.ctx, (ast.Store,)) and \
                    node.id not in names:
                names.append(node.id)

        def visit_FunctionDef(self, node):
            names.append(node.name) if node.name not in names else None

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, node):
            pass

    v = V()
    for s in stmts:
        v.visit(s)
    return names


def _loaded_names(node):
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            out.add(n.id)
        elif isinstance(n, ast.AugAssign) and isinstance(n.target,
                                                         ast.Name):
            # `acc += 1` reads acc but its target carries Store ctx only
            out.add(n.target.id)
    return out


def _undef_guard(name):
    """``name = locals().get('name', __pd_undef)`` — binds a possibly-
    not-yet-assigned name in the enclosing frame so converted branch/thunk
    calls can pass it as a parameter."""
    return ast.Assign(
        targets=[ast.Name(id=name, ctx=ast.Store())],
        value=ast.Call(
            func=ast.Attribute(
                value=ast.Call(func=_name("locals"), args=[], keywords=[]),
                attr="get", ctx=ast.Load()),
            args=[_const(name), _name("__pd_undef")], keywords=[]))


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrite if/while into convert_ifelse/convert_while calls."""

    def __init__(self):
        self.counter = 0

    def _fresh(self, kind):
        self.counter += 1
        return f"__pd_{kind}_{self.counter}"

    def visit_If(self, node):
        self.generic_visit(node)
        _Forbidden("if").visit(ast.Module(body=node.body, type_ignores=[]))
        _Forbidden("if").visit(ast.Module(body=node.orelse, type_ignores=[]))
        import re as _re
        # synthesized converter defs stay branch-local (they are
        # (re)defined before use in each branch) — EXCEPT the loop escape
        # flags, which must flow out of the branch that sets them
        _flag = _re.compile(r"__pd_(brk|cont)_\d+$")
        out_names = sorted(
            n for n in set(_assigned_names(node.body))
            | set(_assigned_names(node.orelse))
            if not n.startswith("__pd_") or _flag.match(n))
        tname, fname = self._fresh("true"), self._fresh("false")
        # branch state travels as PARAMETERS (assign-then-read inside a
        # branch must see the pre-if value, which a closure cannot provide
        # once the name becomes branch-local)
        argspec = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in out_names],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in out_names],
            ctx=ast.Load()))
        true_def = ast.FunctionDef(
            name=tname, args=argspec,
            body=list(node.body) + [ret], decorator_list=[])
        false_def = ast.FunctionDef(
            name=fname, args=argspec,
            body=(list(node.orelse) or [ast.Pass()]) + [ret],
            decorator_list=[])
        # vars first bound inside the if need a pre-call definition:
        # n = locals().get('n', sentinel)
        guards = [_undef_guard(n) for n in out_names]
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in out_names],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__pd_convert_ifelse", ctx=ast.Load()),
                args=[node.test,
                      ast.Name(id=tname, ctx=ast.Load()),
                      ast.Name(id=fname, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                      for n in out_names],
                                ctx=ast.Load()),
                      ast.Constant(value=tuple(out_names))],
                keywords=[]))
        if not out_names:
            # no state escapes: still evaluate for side-free parity
            call = ast.Expr(value=call.value)
        return [true_def, false_def] + guards + [call]

    def _escape_flags(self, body, test):
        """break/continue rewrite for a loop body. Returns (body, test,
        pre_stmts, flag_names): body has escapes lowered to flag sets +
        guard ifs, test (may be None for `for`) is wrapped with the break
        flag, pre_stmts initialize the flags before the loop."""
        brk = self._fresh("brk")
        cont = self._fresh("cont")
        new_body, used = _rewrite_escapes(body, brk, cont)
        if not used:
            return list(body), test, [], []
        # continue resets every iteration; break persists as loop state
        new_body = [_assign(cont, _const(False))] + new_body
        if test is not None:
            test = _call("__pd_loop_guard", _name(brk), test)
        pre = [_assign(brk, _const(False)), _assign(cont, _const(False))]
        return new_body, test, pre, [brk, cont]

    def _build_while(self, test, body_stmts, loop_names, pre=()):
        cname, bname = self._fresh("cond"), self._fresh("body")
        argspec = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in loop_names],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        cond_def = ast.FunctionDef(
            name=cname, args=argspec,
            body=[ast.Return(value=test)], decorator_list=[])
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in loop_names],
            ctx=ast.Load()))
        body_def = ast.FunctionDef(
            name=bname, args=argspec,
            body=list(body_stmts) + [ret], decorator_list=[])
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in loop_names],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__pd_convert_while", ctx=ast.Load()),
                args=[ast.Name(id=cname, ctx=ast.Load()),
                      ast.Name(id=bname, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                      for n in loop_names],
                                ctx=ast.Load())],
                keywords=[]))
        return [cond_def, body_def] + list(pre) + [call]

    def visit_While(self, node):
        if node.orelse:
            raise TranslateError("while/else is not supported in to_static")
        body_stmts, test, pre, flags = self._escape_flags(node.body,
                                                          node.test)
        node = ast.While(test=test, body=body_stmts, orelse=[])
        self.generic_visit(node)  # converts nested ifs incl. escape guards
        _Forbidden("while").visit(
            ast.Module(body=node.body, type_ignores=[]))
        # EVERY name assigned in the body is loop state: a store-only
        # accumulator (written in the loop, read only after it) must still
        # flow out through the converted call or post-loop reads would see
        # the stale pre-loop value
        loop_names = sorted(
            set(n for n in _assigned_names(node.body)
                if not n.startswith("__pd_")) | set(flags))
        if not loop_names:
            raise TranslateError(
                "while loop carries no tensor state; convert_while needs "
                "loop variables assigned in the body")
        return self._build_while(node.test, node.body, loop_names, pre)

    def visit_For(self, node):
        """``for <name> in range(...)`` -> convert_for_range (SOT-lite).
        Any other iterable is left to plain python/tracing semantics."""
        if node.orelse:
            raise TranslateError("for/else is not supported in to_static")
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and not node.iter.keywords
                    and 1 <= len(node.iter.args) <= 3
                    and isinstance(node.target, ast.Name))
        if not is_range:
            self.generic_visit(node)
            return node  # plain python iteration (eager or static unroll)
        body_stmts, _, pre, flags = self._escape_flags(node.body, None)
        args = node.iter.args
        start = args[0] if len(args) >= 2 else ast.Constant(value=0)
        stop = args[1] if len(args) >= 2 else args[0]
        step = args[2] if len(args) == 3 else ast.Constant(value=1)
        # a negative literal (`range(10, 0, -1)`) parses as
        # UnaryOp(USub, Constant); fold it so the constant-step checks and
        # the comparison-direction read below see a plain negative value
        if isinstance(step, ast.UnaryOp) and isinstance(step.op, ast.USub) \
                and isinstance(step.operand, ast.Constant):
            step = ast.Constant(value=-step.operand.value)
        if flags and not isinstance(step, ast.Constant):
            raise TranslateError(
                "for-range with break needs a constant step in to_static")
        tgt = node.target.id
        node2 = ast.For(target=node.target, iter=node.iter,
                        body=body_stmts, orelse=[])
        self.generic_visit(node2)
        _Forbidden("for").visit(
            ast.Module(body=node2.body, type_ignores=[]))
        loop_names = sorted(
            set(n for n in _assigned_names(node2.body)
                if n != tgt and (not n.startswith("__pd_") or n in flags))
            | set(flags))
        bname = self._fresh("forbody")
        argspec = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=tgt)] + [
                ast.arg(arg=n) for n in loop_names],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in loop_names],
            ctx=ast.Load()))
        body_def = ast.FunctionDef(
            name=bname, args=argspec,
            body=list(node2.body) + [ret], decorator_list=[])
        if flags:
            # break: fold the flag into the stop condition by running the
            # range via convert_while with a guarded test. start/stop are
            # evaluated ONCE into temps (python range() semantics), which
            # also lets the post-loop target binding reuse them.
            brk = flags[0]
            i_name = self._fresh("idx")
            s_name = self._fresh("start")
            e_name = self._fresh("stop")
            test = _call("__pd_loop_guard", _name(brk),
                         ast.Compare(left=_name(i_name), ops=[ast.Lt()],
                                     comparators=[_name(e_name)])
                         if step.value > 0 else
                         ast.Compare(left=_name(i_name), ops=[ast.Gt()],
                                     comparators=[_name(e_name)]))
            # while-state: index + loop vars; body calls body_def then
            # increments the index
            inner = [
                ast.Assign(
                    targets=[ast.Tuple(
                        elts=[ast.Name(id=n, ctx=ast.Store())
                              for n in loop_names], ctx=ast.Store())],
                    value=ast.Call(func=_name(bname),
                                   args=[_name(i_name)] + [
                                       _name(n) for n in loop_names],
                                   keywords=[])),
                ast.Assign(
                    targets=[ast.Name(id=i_name, ctx=ast.Store())],
                    value=ast.BinOp(left=_name(i_name), op=ast.Add(),
                                    right=step)),
            ]
            pre2 = [body_def, _assign(s_name, start),
                    _assign(e_name, stop), _assign(i_name, _name(s_name))] \
                + pre
            out = self._build_while(test, inner,
                                    [i_name] + list(loop_names), pre=[])
            # python binds the loop target after the loop (break leaves it
            # at the break-iteration index; the wrapper incremented past it)
            post = [_assign(tgt, _call("__pd_post_idx", _name(i_name),
                                       _name(s_name), _name(e_name), step))]
            # _build_while emits [cond_def, body_def2, call]; wrap setup +
            # target binding around it
            return pre2 + out + post
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=tgt, ctx=ast.Store())] + [
                    ast.Name(id=n, ctx=ast.Store()) for n in loop_names],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__pd_convert_for_range", ctx=ast.Load()),
                args=[start, stop, step, _name(bname),
                      ast.Tuple(elts=[_name(n) for n in loop_names],
                                ctx=ast.Load())],
                keywords=[]))
        return [body_def] + pre + [call]


def _noargs():
    return ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                         kw_defaults=[], defaults=[])


@functools.lru_cache(maxsize=128)
def _transform_cached(func):
    return _transform(func)


def _transform(func):
    """AST-rewrite ``func``'s if/while into converter calls; returns the new
    function (or raises TranslateError / OSError for the caller to fall
    back on plain tracing)."""
    source = textwrap.dedent(inspect.getsource(func))
    tree = ast.parse(source)
    fdef = tree.body[0]
    # drop only to_static-style decorators (they'd re-wrap); every other
    # decorator (no_grad, user caching, ...) must keep applying
    def _is_to_static_deco(d):
        target = d.func if isinstance(d, ast.Call) else d
        if isinstance(target, ast.Name):
            return target.id == "to_static"
        if isinstance(target, ast.Attribute):
            return target.attr == "to_static"
        return False

    fdef.decorator_list = [d for d in fdef.decorator_list
                           if not _is_to_static_deco(d)]
    # early-return CPS first (it consumes return-bearing ifs), then the
    # control-flow transformer (it converts everything left, including the
    # bodies of the CPS thunks)
    fdef.body = _functionalize_returns(fdef.body, [0])
    new = _ControlFlowTransformer().visit(tree)
    ast.fix_missing_locations(new)
    code = compile(new, filename=f"<dy2static {func.__name__}>", mode="exec")
    glb = dict(func.__globals__)
    glb["__pd_convert_ifelse"] = convert_ifelse
    glb["__pd_convert_while"] = convert_while
    glb["__pd_convert_for_range"] = convert_for_range
    glb["__pd_cps_if"] = convert_ifelse_value
    glb["__pd_post_idx"] = post_loop_index
    glb["__pd_loop_guard"] = loop_guard
    glb["__pd_not_escaped"] = not_escaped
    glb["__pd_undef"] = _UNDEF
    if func.__closure__:
        # rebind closure cells as globals (converted code is closure-free)
        for name, cell in zip(func.__code__.co_freevars, func.__closure__):
            try:
                glb[name] = cell.cell_contents
            except ValueError:
                pass
    loc = {}
    exec(code, glb, loc)
    out = loc[fdef.name]
    # recursion resolves to the CONVERTED function, not the original
    glb[fdef.name] = out
    out.__pd_dy2static__ = True
    return out


def convert_to_static(func):
    """Best-effort dy2static: AST-convert control flow; on failure return
    the original function and record the graph-break reason on it."""
    try:
        return _transform_cached(func)
    except (TranslateError, OSError, TypeError, SyntaxError) as e:
        try:
            func.__pd_graph_break__ = f"{type(e).__name__}: {e}"
        except (AttributeError, TypeError):
            pass
        return func
