"""paddle.static of the port (``paddle_tpu_torch/static/``) against the JAX
package: the nine Executor cases of ``tests/test_static_executor.py`` run
in both packages on the same numpy feeds (``exe._cache`` included), then
``static.nn``'s ``cond``, ``while_loop``, ``case``, ``switch_case``,
``fc``, ``batch_norm`` and ``embedding``, eagerly, under ``to_static``
and (the layer helpers) on placeholders through the Executor.

Values agree within 1e-5 (atol and rtol): elementwise ops, 4- to
12-wide products and batch statistics over 32 values. The layers
``fc`` and ``embedding`` build draw random weights; the port's are set to
the reference's (its ``nn.Linear``/``nn.Embedding`` recorded as built).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from _torch_ops_sweep import on_cpu  # noqa: F401  (the port's place: CPU)

TOL = dict(rtol=1e-5, atol=1e-5)


def _feeds(seed):
    rng = np.random.default_rng(seed)
    return {"u24": rng.uniform(0, 1, (2, 4)).astype("float32"),
            "a23": rng.uniform(-1, 1, (2, 3)).astype("float32"),
            "b23": rng.uniform(-1, 1, (2, 3)).astype("float32"),
            "a34": rng.uniform(-1, 1, (3, 4)).astype("float32")}


def _linear(pd, i, o):
    return pd.nn.Linear(i, o, **({"device": "cpu"} if pd is tpaddle
                                 else {}))


# -- the Executor cases: each returns a list of fetched arrays ---------------

def data_feed_fetch(pd, f):
    x = pd.static.data("x", [None, 4])
    y = pd.exp(x)
    return pd.static.Executor().run(feed={"x": f["u24"]}, fetch_list=[y])


def multi_op_graph_and_operators(pd, f):
    x = pd.static.data("x", [None, 3])
    z = pd.static.data("z", [None, 3])
    y = pd.tanh(x * 2.0 + z)
    s = pd.sum(y)
    return pd.static.Executor().run(feed={"x": f["a23"], "z": f["b23"]},
                                    fetch_list=[y, s])


def layers_work_on_placeholders(pd, f, weights=None):
    net = _linear(pd, 4, 2)
    if weights is not None:
        with torch.no_grad():
            net.weight.copy_(torch.from_numpy(weights[0]))
            net.bias.copy_(torch.from_numpy(weights[1]))
    x = pd.static.data("x", [None, 4])
    out = net(x)
    got = pd.static.Executor().run(feed={"x": f["a34"]}, fetch_list=[out])
    w = [np.array(p.detach().numpy()) for p in (net.weight, net.bias)]
    np.testing.assert_allclose(got[0], f["a34"] @ w[0] + w[1], **TOL)
    return got, w


def program_guard_and_startup_run(pd, f):
    main, startup = pd.static.Program(), pd.static.Program()
    with pd.static.program_guard(main, startup):
        x = pd.static.data("x", [None, 2])
        y = x * 3.0
    exe = pd.static.Executor()
    assert exe.run(startup) == []
    return exe.run(main, feed={"x": np.ones((1, 2), "float32")},
                   fetch_list=[y])


def missing_feed_raises(pd, f):
    x = pd.static.data("x", [None, 2])
    y = x + 1.0
    with pytest.raises(KeyError, match="missing feed 'x'"):
        pd.static.Executor().run(feed={}, fetch_list=[y])
    return []


def static_gradients(pd, f):
    x = pd.static.data("x", [3])
    loss = pd.sum(pd.square(x))
    (gx,) = pd.static.gradients(loss, [x])
    return pd.static.Executor().run(
        feed={"x": np.array([1.0, -2.0, 3.0], "float32")},
        fetch_list=[gx, loss])


def executor_caches_compilation(pd, f):
    x = pd.static.data("x", [None, 4])
    y = pd.exp(x)
    exe = pd.static.Executor()
    sizes = []
    for a in (f["u24"], f["u24"] + 1, np.zeros((5, 4), "float32")):
        exe.run(feed={"x": a}, fetch_list=[y])
        sizes.append(len(exe._cache))
    return [np.array(sizes)]


def multi_output_op_in_static_graph(pd, f):
    x = pd.static.data("x", [4])
    vals, idx = pd.topk(x, k=2)
    return pd.static.Executor().run(
        feed={"x": np.array([1.0, 9.0, 3.0, 7.0], "float32")},
        fetch_list=[vals, idx])


def gradients_fetched_with_target_same_run(pd, f):
    x = pd.static.data("x", [3])
    y = pd.exp(x)
    (gx,) = pd.static.gradients([y], [x])
    return pd.static.Executor().run(
        feed={"x": np.array([0.1, 0.5, 1.0], "float32")}, fetch_list=[y, gx])


EXECUTOR_CASES = [data_feed_fetch, multi_op_graph_and_operators,
                  layers_work_on_placeholders, program_guard_and_startup_run,
                  missing_feed_raises, static_gradients,
                  executor_caches_compilation,
                  multi_output_op_in_static_graph,
                  gradients_fetched_with_target_same_run]


@pytest.mark.parametrize("case", EXECUTOR_CASES,
                         ids=[c.__name__ for c in EXECUTOR_CASES])
def test_executor_case_matches_the_reference(case):
    f = _feeds(3)
    if case is layers_work_on_placeholders:
        want, w = case(jpaddle, f)
        got, _ = case(tpaddle, f, w)
    else:
        want, got = case(jpaddle, f), case(tpaddle, f)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.shape == np.asarray(w_).shape
        np.testing.assert_allclose(g, w_, **TOL)


def test_host_reads_and_in_place_writes_on_a_variable_raise():
    x = tpaddle.static.data("x", [3])
    y = tpaddle.exp(x)
    with pytest.raises(RuntimeError, match="no value before Executor.run"):
        bool(y.sum() > 0)
    with pytest.raises(RuntimeError, match="no value before Executor.run"):
        y.numpy()
    with pytest.raises(RuntimeError, match="in-place"):
        y.add_(1.0)
    assert y.shape == (3,) and "op" in repr(y)


def test_batch_norm_on_a_placeholder_is_the_eager_one():
    # the reference's batch_norm reads a placeholder's size, which its
    # Variable lacks; the port's is held to its own eager call
    x = np.random.default_rng(5).normal(size=(2, 3, 4, 4)).astype("float32")
    eager = tpaddle.static.nn.batch_norm(_t(tpaddle, x), act="relu")
    v = tpaddle.static.data("bn_x", [2, 3, 4, 4])
    out = tpaddle.static.nn.batch_norm(v, act="relu")
    got, = tpaddle.static.Executor().run(feed={"bn_x": x}, fetch_list=[out])
    np.testing.assert_array_equal(got, eager.numpy())


# -- static.nn -----------------------------------------------------------------

def _t(pd, a):
    return pd.to_tensor(np.asarray(a))


def nn_cond(pd):
    x = _t(pd, np.array([2.0, -1.0], "float32"))
    eager = [pd.static.nn.cond(pd.sum(x) > 0, lambda: x * 10.0,
                               lambda: x - 1.0),
             pd.static.nn.cond(pd.sum(x) < 0, lambda: x * 10.0,
                               lambda: (x - 1.0, x + 1.0))[1]]

    @pd.jit.to_static
    def f(x):
        return pd.static.nn.cond(pd.sum(x) > 0, lambda: (x * 10.0, x),
                                 lambda: (x - 1.0, x * x))

    traced = [*f(x), *f(x * -1.0)]
    return eager + traced


def nn_while_loop(pd):
    i = _t(pd, np.array(0, "int64"))
    ten = _t(pd, np.array(10, "int64"))
    eager = pd.static.nn.while_loop(lambda i: i < ten, lambda i: [i + 3],
                                    [i])

    @pd.jit.to_static
    def f(x):
        return pd.static.nn.while_loop(
            lambda x, k: pd.sum(x) < 50.0, lambda x, k: [x * 3.0, k + 1],
            [x, _t(pd, np.array(0, "int64"))])

    return [*eager, *f(_t(pd, np.array([1.0, 1.0], "float32")))]


def nn_case(pd):
    def run(x):
        s = pd.sum(x)
        return pd.static.nn.case(
            [(s > 10.0, lambda: x * 3.0), (s > 0.0, lambda: x * 2.0)],
            default=lambda: x * 0.5)

    vals = [np.array(v, "float32") for v in ([6.0, 6.0], [1.0, 1.0],
                                             [-4.0, 0.0])]
    traced = pd.jit.to_static(run)
    return [run(_t(pd, v)) for v in vals] + [traced(_t(pd, v))
                                             for v in vals]


def nn_switch_case(pd):
    def run(x, idx):
        return pd.static.nn.switch_case(
            idx, [lambda: x + 1.0, lambda: x * 5.0, lambda: x - 2.0])

    x = _t(pd, np.array([1.0, 2.0], "float32"))
    traced = pd.jit.to_static(run)
    return [g(x, _t(pd, np.array(k, "int64"))) for g in (run, traced)
            for k in (0, 1, 2, 9)]


def nn_batch_norm(pd):
    x = np.random.default_rng(5).normal(size=(2, 3, 4, 4)).astype("float32")
    return [pd.static.nn.batch_norm(_t(pd, x), act="relu"),
            pd.static.nn.batch_norm(_t(pd, x * 2.0 + 1.0))]


def nn_fc(pd):
    x = np.random.default_rng(6).normal(size=(2, 3, 4)).astype("float32")
    eager = pd.static.nn.fc(_t(pd, x), 5, activation="relu")
    v = pd.static.data("fc_x", [2, 3, 4])
    out = pd.static.nn.fc(v, 3, num_flatten_dims=2)
    got, = pd.static.Executor().run(feed={"fc_x": x}, fetch_list=[out])
    return [eager, got]


def nn_embedding(pd):
    ids = np.random.default_rng(7).integers(0, 10, (2, 3))
    eager = pd.static.nn.embedding(_t(pd, ids), [10, 4])
    v = pd.static.data("emb_ids", [2, 3], "int64")
    out = pd.static.nn.embedding(v, [10, 4], padding_idx=0)
    got, = pd.static.Executor().run(feed={"emb_ids": ids}, fetch_list=[out])
    return [eager, got]


NN_CASES = [nn_cond, nn_while_loop, nn_case, nn_switch_case, nn_batch_norm,
            nn_fc, nn_embedding]


def _carry_weights(monkeypatch, name):
    """Record the reference's layers of class ``name`` as built; the
    port's layers of that class, built in the same order, take their
    weights."""
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as tnn
    made = []
    jcls, tcls = getattr(jnn, name), getattr(tnn, name)

    class Recorded(jcls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    class Carried(tcls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            ref = made.pop(0)
            with torch.no_grad():
                for pname, p in self.named_parameters():
                    p.copy_(torch.from_numpy(np.array(
                        getattr(ref, pname).numpy())))

    monkeypatch.setattr(jnn, name, Recorded)
    monkeypatch.setattr(tnn, name, Carried)


def _arrays(out):
    return [np.asarray(o if isinstance(o, np.ndarray) else o.numpy())
            for o in out]


@pytest.mark.parametrize("case", NN_CASES, ids=[c.__name__ for c in NN_CASES])
def test_static_nn_matches_the_reference(case, monkeypatch):
    for name in ("Linear", "Embedding"):
        _carry_weights(monkeypatch, name)
    want = _arrays(case(jpaddle))
    got = _arrays(case(tpaddle))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
