"""dy2static and ``to_static`` of the port (``paddle_tpu_torch/jit/
dy2static.py``, ``jit/trace.py``) against the JAX package: every function
and model of ``tests/test_dy2static.py`` runs through ``to_static`` in
both packages on the same numpy inputs, one parametrised case each.

Outputs agree within 1e-5 (atol and rtol; the functions compute exact
small integers, the models two 4-wide matrix products). The port lowers
a traced ``if`` onto the cond op and a traced ``while`` (and a ``for``
over a tensor ``range``) onto the while_loop op; the cases that must
capture those ops check that the port's program holds them. The
graph-break case checks the reason both packages record; the one-branch
binding case, the error both raise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from _torch_ops_sweep import on_cpu  # noqa: F401  (the port's place: CPU)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x.numpy())


def _t(pd, a):
    return pd.to_tensor(np.asarray(a))


def _ops(fn):
    """The higher-order ops in the port's captured programs of ``fn``."""
    traced = getattr(fn, "_static_forward", None) or fn.concrete_program
    return {n.target.name()
            for ep, _ in traced.programs.values()
            for gm in ep.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes
            if isinstance(n.target, torch._ops.HigherOrderOperator)}


# -- the cases: each builds its function in the package ``pd`` and returns
#    (outputs, the port function or None) -------------------------------------

def if_else_both_branches(pd):
    @pd.jit.to_static
    def f(x):
        if pd.sum(x) > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y

    return [f(_t(pd, np.array([1.0, 2.0], "float32"))),
            f(_t(pd, np.array([-3.0, 1.0], "float32")))], f


def elif_chain(pd):
    @pd.jit.to_static
    def f(x):
        s = pd.sum(x)
        if s > 10.0:
            y = x * 3.0
        elif s > 0.0:
            y = x * 2.0
        else:
            y = x * 0.0
        return y

    return [f(_t(pd, np.array(v, "float32")))
            for v in ([6.0, 6.0], [1.0, 1.0], [-9.0, 0.0])], f


def python_bool_predicate_stays_python(pd):
    @pd.jit.to_static
    def f(x, flag=True):
        if flag:  # concrete Python bool: plain branching
            y = x + 1.0
        else:
            y = x - 1.0
        return y

    x = _t(pd, np.array([1.0], "float32"))
    return [f(x), f(x, flag=False)], None


def while_on_tensor(pd):
    @pd.jit.to_static
    def f(x):
        i = pd.to_tensor(np.array(0.0, "float32"))
        while i < 5.0:
            x = x * 2.0
            i = i + 1.0
        return x

    return [f(_t(pd, np.array([1.0, 3.0], "float32")))], None


def while_data_dependent_trip_count(pd):
    @pd.jit.to_static
    def f(x):
        while pd.sum(x) < 100.0:
            x = x * 2.0
        return x

    return [f(_t(pd, np.array([1.0], "float32"))),
            f(_t(pd, np.array([60.0], "float32")))], f


def graph_break_falls_back_with_reason(pd):
    mod = __import__(pd.__name__ + ".jit.dy2static",
                     fromlist=["convert_to_static"])

    def f(x):
        i = pd.to_tensor(np.array(0.0, "float32"))
        while i < 5.0:
            if pd.sum(x) > 3.0:
                return x  # return inside a converted loop: unsupported
            i = i + 1.0
        return x * 2.0

    g = mod.convert_to_static(f)
    assert g is f
    return f.__pd_graph_break__, None


def early_return_in_branch_converts(pd):
    mod = __import__(pd.__name__ + ".jit.dy2static",
                     fromlist=["convert_to_static"])

    def f(x):
        if pd.sum(x) > 0:
            return x * 2.0
        return x

    g = mod.convert_to_static(f)
    assert g is not f
    return [g(_t(pd, np.array([1.0, 2.0], "float32"))),
            g(_t(pd, np.array([-3.0, 1.0], "float32")))], None


def static_nn_cond_eager_and_traced(pd):
    x = _t(pd, np.array([2.0], "float32"))
    eager = pd.static.nn.cond(pd.sum(x) > 0, lambda: x * 10.0, lambda: x)

    @pd.jit.to_static
    def f(x):
        return pd.static.nn.cond(pd.sum(x) > 0, lambda: x * 10.0,
                                 lambda: x)

    return [eager, f(_t(pd, np.array([-2.0], "float32"))),
            f(_t(pd, np.array([3.0], "float32")))], f


def static_nn_while_loop_api(pd):
    i = _t(pd, np.array(0, "int64"))
    ten = _t(pd, np.array(10, "int64"))
    return pd.static.nn.while_loop(lambda i: i < ten, lambda i: [i + 2],
                                   [i]), None


def static_nn_switch_case(pd):
    @pd.jit.to_static
    def f(x, idx):
        return pd.static.nn.switch_case(
            idx, {1: lambda: x + 1.0, 3: lambda: x + 3.0},
            default=lambda: x * 0.0)

    x = _t(pd, np.array([1.0], "float32"))
    return [f(x, _t(pd, np.array(k, "int64"))) for k in (1, 3, 7)], f


def if_inside_while(pd):
    @pd.jit.to_static
    def f(x):
        i = pd.to_tensor(np.array(0.0, "float32"))
        while i < 4.0:
            if pd.sum(x) > 50.0:
                x = x + 1.0
            else:
                x = x * 2.0
            i = i + 1.0
        return x

    return [f(_t(pd, np.array([10.0, 10.0], "float32")))], f


def while_store_only_accumulator(pd):
    @pd.jit.to_static
    def f(n):
        i = pd.to_tensor(np.array(0.0, "float32"))
        last = pd.to_tensor(np.array(-1.0, "float32"))
        while i < n:
            last = i * 10.0
            i = i + 1.0
        return i, last

    return list(f(_t(pd, np.array(3.0, "float32")))), f


def one_branch_binding_raises(pd):
    @pd.jit.to_static
    def f(x):
        if pd.sum(x) > 0:
            y = x * 2.0
        return y  # noqa: F821 - deliberately one-branch-bound

    with pytest.raises(Exception, match="bound in only one branch") as e:
        f(_t(pd, np.array([1.0], "float32")))
    return "bound in only one branch" in str(e.value), None


def for_over_tensor_range(pd):
    @pd.jit.to_static
    def f(x, n):
        acc = x * 0.0
        for i in range(n):
            acc = acc + x * i
        return acc

    x = _t(pd, np.ones(3, "float32"))
    out = [f(x, _t(pd, np.int64(4))), f(x, _t(pd, np.int64(6)))]
    return out, f


def for_range_start_step(pd):
    @pd.jit.to_static
    def f(x, n):
        acc = x * 0.0
        for i in range(2, n, 3):
            acc = acc + x * i
        return acc

    return [f(_t(pd, np.ones(2, "float32")), _t(pd, np.int64(10)))], f


def break_and_continue(pd):
    @pd.jit.to_static
    def f(x, n):
        acc = x * 0.0
        for i in range(n):
            if i == 2:
                continue
            if i >= 5:
                break
            acc = acc + x * i
        return acc

    return [f(_t(pd, np.ones(3, "float32")), _t(pd, np.int64(100)))], f


def while_break(pd):
    @pd.jit.to_static
    def f(x):
        i = pd.to_tensor(np.int64(0))
        acc = x * 0.0
        while i < 100:
            acc = acc + x
            i = i + 1
            if i >= 7:
                break
        return acc

    return [f(_t(pd, np.ones(3, "float32")))], None


def early_return_both_paths(pd):
    @pd.jit.to_static
    def f(x):
        if pd.sum(x) > 10.0:
            return x * 2.0
        y = x + 1.0
        return y * 3.0

    return [f(_t(pd, np.ones(3, "float32"))),
            f(_t(pd, np.full(3, 10.0, "float32")))], f


def guard_clause_chain(pd):
    @pd.jit.to_static
    def f(x):
        if pd.sum(x) < 0.0:
            return x * 0.0
        if pd.sum(x) < 10.0:
            return x + 100.0
        return x - 1.0

    return [f(_t(pd, np.full(3, v, "float32"))) for v in (-1.0, 1.0, 20.0)
            ], f


def guard_clause_then_read_modify_write(pd):
    @pd.jit.to_static
    def f(x):
        acc = pd.sum(x)
        if pd.sum(x) > 100.0:
            return acc
        acc = acc + 1.0
        return acc

    return [f(_t(pd, np.ones(3, "float32"))),
            f(_t(pd, np.full(3, 50.0, "float32")))], f


def post_loop_index_matches_python(pd):
    @pd.jit.to_static
    def f(x, n):
        for i in range(n):
            x = x + 1.0
        return x, i

    @pd.jit.to_static
    def g(x, n):
        for i in range(2, n, 3):
            x = x + 1.0
        return x, i

    zero = np.zeros(1, "float32")
    return [*f(_t(pd, zero), _t(pd, np.int64(8))),
            *g(_t(pd, zero), _t(pd, np.int64(10)))], f


def post_loop_index_through_break_path(pd):
    @pd.jit.to_static
    def f(x, n):
        for i in range(n):
            x = x + 1.0
            if i >= 3:
                break
        return x, i

    zero = np.zeros(1, "float32")
    return [*f(_t(pd, zero), _t(pd, np.int64(100))),
            *f(_t(pd, zero), _t(pd, np.int64(2)))], f


def augassign_in_continuation(pd):
    @pd.jit.to_static
    def f(x):
        acc = pd.sum(x)
        if pd.sum(x) > 100.0:
            return acc
        acc += 1.0
        return acc

    return [f(_t(pd, np.ones(3, "float32"))),
            f(_t(pd, np.full(3, 50.0, "float32")))], f


def negative_literal_step_with_break(pd):
    mod = __import__(pd.__name__ + ".jit.dy2static",
                     fromlist=["convert_to_static"])

    def f(x, n):
        acc = x * 0.0
        for i in range(10, 0, -1):
            if i <= 6:
                break
            acc = acc + x * i
        return acc

    assert mod.convert_to_static(f) is not f, \
        getattr(f, "__pd_graph_break__", "")
    return [pd.jit.to_static(f)(_t(pd, np.ones(2, "float32")),
                                _t(pd, np.int64(0)))], None


CASES = [if_else_both_branches, elif_chain,
         python_bool_predicate_stays_python, while_on_tensor,
         while_data_dependent_trip_count, graph_break_falls_back_with_reason,
         early_return_in_branch_converts, static_nn_cond_eager_and_traced,
         static_nn_while_loop_api, static_nn_switch_case, if_inside_while,
         while_store_only_accumulator, one_branch_binding_raises,
         for_over_tensor_range, for_range_start_step, break_and_continue,
         while_break, early_return_both_paths, guard_clause_chain,
         guard_clause_then_read_modify_write, post_loop_index_matches_python,
         post_loop_index_through_break_path, augassign_in_continuation,
         negative_literal_step_with_break]

# the cases whose port programs must hold the cond or the while_loop op
OPS = {"if_else_both_branches": {"cond"}, "elif_chain": {"cond"},
       "while_data_dependent_trip_count": {"while_loop"},
       "static_nn_cond_eager_and_traced": {"cond"},
       "static_nn_switch_case": {"cond"},
       "if_inside_while": {"cond"},
       "for_over_tensor_range": {"while_loop"},
       "break_and_continue": {"while_loop", "cond"},
       "early_return_both_paths": {"cond"}}


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_case_matches_the_reference(case):
    want, _ = case(jpaddle)
    got, fn = case(tpaddle)
    if isinstance(want, (str, bool)):
        assert got == want
        return
    want, got = _np(want), _np(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    if fn is not None:
        assert OPS.get(case.__name__, set()) <= _ops(fn), _ops(fn)
    if case is for_over_tensor_range:
        # one program for both trip counts: the bound is an input
        assert len(fn.concrete_program.programs) == 1


# -- the loop-bearing models, saved, reloaded and re-run ----------------------

def _loopnet(pd, port):
    class LoopNet(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pd.nn.Linear(4, 4, **({"device": "cpu"} if port
                                            else {}))

        def forward(self, x):
            y = self.fc(x)
            while pd.sum(pd.abs(y)) < 10.0:
                y = y * 2.0
            return y

    return LoopNet()


def _sotnet(pd, port):
    class SotNet(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pd.nn.Linear(4, 4, **({"device": "cpu"} if port
                                            else {}))

        def forward(self, x, n):
            y = self.fc(x)
            if pd.sum(y) > 100.0:
                return y * 0.5  # early return from a converted branch
            acc = y * 0.0
            for i in range(n):  # tensor trip count: the while_loop op
                acc = acc + y * (i + 1)
            return acc

    return SotNet()


def _round_trip(pd, port, build, specs, inputs, tmp_path, seed):
    jpaddle.seed(seed)
    net = build(pd, port)
    if port:
        ref = build(jpaddle, False)
        net.fc.weight.data.copy_(
            torch.from_numpy(np.array(ref.fc.weight.numpy())))
        net.fc.bias.data.copy_(
            torch.from_numpy(np.array(ref.fc.bias.numpy())))
    net.eval()
    args = [_t(pd, a) for a in inputs]
    eager = net(*args)
    static = pd.jit.to_static(net)(*args)
    path = str(tmp_path / ("port" if port else "ref"))
    pd.jit.save(net, path, input_spec=[pd.static.InputSpec(*s)
                                       for s in specs])
    loaded = pd.jit.load(path, **({"device": "cpu"} if port else {}))
    out = loaded(*args)
    first = lambda o: o[0] if isinstance(o, (list, tuple)) else o  # noqa
    return [_np(eager), _np(first(static)), _np(first(out))], net


MODELS = {
    "loopnet": (_loopnet, [([2, 4], "float32")],
                lambda: [np.random.default_rng(0).uniform(
                    0.1, 0.5, (2, 4)).astype("float32")], 0, "while_loop"),
    "sotnet": (_sotnet, [([2, 4], "float32"), ([], "int64")],
               lambda: [np.random.default_rng(1).uniform(
                   0.1, 0.5, (2, 4)).astype("float32"), np.int64(3)], 7,
               "cond"),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_traces_saves_reloads_with_the_references_outputs(model,
                                                                tmp_path):
    build, specs, inputs, seed, op = MODELS[model]
    want, _ = _round_trip(jpaddle, False, build, specs, inputs(), tmp_path,
                          seed)
    got, net = _round_trip(tpaddle, True, build, specs, inputs(), tmp_path,
                           seed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got[1], got[0], **TOL)
    np.testing.assert_allclose(got[2], got[0], **TOL)
    assert op in _ops(net)
