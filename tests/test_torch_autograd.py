"""The autograd surface of the port against the reference: the same
seeded numpy inputs through both packages' ``backward``, ``paddle.grad``
(``allow_unused``, ``no_grad_vars``, ``create_graph``), ``no_grad``,
``PyLayer``, ``register_hook``, ``retain_grads``, the functional
``vjp``/``jvp``/``jacobian``/``hessian``, and the port's
``register_grad_ready_hook`` (once per leaf, with the final gradient).
Gradients are held at 1e-6 relative (float32, a few ops)."""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from _torch_ops_sweep import on_cpu  # noqa: F401  (autouse fixture)

PACKAGES = (paddle_tpu, paddle_tpu_torch)
RTOL = 1e-6


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, s).astype(np.float32) for s in shapes]


def _both(fn):
    """``fn(paddle)`` on each package; the port's result against the
    reference's, element by element."""
    want, got = fn(paddle_tpu), fn(paddle_tpu_torch)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if w is None or g is None:
            assert w is None and g is None
            continue
        np.testing.assert_allclose(np.asarray(g.numpy()),
                                   np.asarray(w.numpy()), rtol=RTOL,
                                   atol=1e-7)
    return got


def test_backward_chain_and_accumulation():
    a, b = _arrays(0, (3, 4), (4, 2))

    def run(paddle):
        x = paddle.to_tensor(a, stop_gradient=False)
        w = paddle.to_tensor(b, stop_gradient=False)
        h = paddle.tanh(paddle.matmul(x, w))
        (h * h).mean().backward()
        paddle.exp(w).sum().backward()        # accumulates into w.grad
        return [x.grad, w.grad]
    _both(run)


def test_backward_with_a_gradient_and_on_a_leaf():
    a, g = _arrays(1, (2, 3), (2, 3))

    def run(paddle):
        x = paddle.to_tensor(a, stop_gradient=False)
        y = paddle.sin(x)
        y.backward(paddle.to_tensor(g))
        leaf = paddle.to_tensor(a, stop_gradient=False)
        paddle.sum(leaf).backward()
        return [x.grad, leaf.grad]
    _both(run)


def test_backward_errors():
    for paddle in PACKAGES:
        x = paddle.to_tensor([1.0, 2.0])
        with pytest.raises(RuntimeError):
            (x * 2).sum().backward()        # nothing needs a gradient
        y = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
        with pytest.raises(RuntimeError):
            (y * 2).backward()              # not a scalar
        z = (y * y).sum()
        z.backward()
        with pytest.raises(RuntimeError):
            z.backward()                    # graph freed


def test_retain_graph_twice():
    (a,) = _arrays(2, (5,))

    def run(paddle):
        x = paddle.to_tensor(a, stop_gradient=False)
        y = (paddle.exp(x) * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        return [x.grad]
    _both(run)


def test_grad_leaves_dot_grad_alone_and_allow_unused():
    a, b = _arrays(3, (3,), (3,))

    def run(paddle):
        x = paddle.to_tensor(a, stop_gradient=False)
        u = paddle.to_tensor(b, stop_gradient=False)
        y = (x * x * 3.0).sum()
        gx, gu = paddle.grad(y, [x, u], allow_unused=True)
        assert x.grad is None and u.grad is None and gu is None
        gx2, gu2 = paddle.grad((x * 2.0).sum(), [x, u])
        assert gu2.numpy().tolist() == [0.0, 0.0, 0.0]
        return [gx, gx2, gu2]
    _both(run)


def test_grad_with_outputs_and_grad_outputs():
    a, g1, g2 = _arrays(4, (2, 2), (2, 2), (2, 2))

    def run(paddle):
        x = paddle.to_tensor(a, stop_gradient=False)
        y1, y2 = paddle.exp(x), x * x
        (gx,) = paddle.grad([y1, y2], [x],
                            grad_outputs=[paddle.to_tensor(g1),
                                          paddle.to_tensor(g2)])
        return [gx]
    _both(run)


def test_grad_no_grad_vars():
    """A tensor in ``no_grad_vars`` is held constant (upstream's meaning;
    the reference takes the argument and ignores it: ROADMAP C)."""
    (a,) = _arrays(5, (4,))
    p = paddle_tpu_torch
    x = p.to_tensor(a, stop_gradient=False)
    h = x * x
    y = (h * x).sum()
    (gx,) = p.grad(y, x, no_grad_vars=[h])
    np.testing.assert_allclose(gx.numpy(), a * a, rtol=RTOL)
    (full,) = p.grad((x * x * x).sum(), x)
    np.testing.assert_allclose(full.numpy(), 3 * a * a, rtol=1e-5)


def test_grad_create_graph_second_order():
    (a,) = _arrays(6, (3,))

    def run(paddle):
        x = paddle.to_tensor(a, stop_gradient=False)
        y = (x ** 3).sum()
        (g,) = paddle.grad(y, x, create_graph=True)
        (gg,) = paddle.grad(g.sum(), x)
        return [g, gg]
    got = _both(run)
    np.testing.assert_allclose(got[1].numpy(), 6 * a, rtol=1e-5)


def test_create_graph_through_flash_attention_raises():
    """K3 has no double backward: a gradient that would carry a graph
    through it raises (on the CPU the plain backward stands in and raises
    the same way)."""
    p = paddle_tpu_torch
    from paddle_tpu_torch.nn import functional as F
    q, k, v = (p.to_tensor(a, stop_gradient=False)
               for a in _arrays(7, (1, 128, 2, 64), (1, 128, 2, 64),
                                (1, 128, 2, 64)))
    out, _ = F.flash_attention(q, k, v, causal=True)
    with pytest.raises(RuntimeError, match="double backward"):
        p.grad(out.sum(), q, create_graph=True)
    (gq,) = p.grad(out.sum(), q)
    assert gq.shape == q.shape


def test_no_grad_and_grad_modes():
    for paddle in PACKAGES:
        x = paddle.to_tensor([1.0], stop_gradient=False)
        with paddle.no_grad():
            assert not paddle.is_grad_enabled()
            y = x * 2
            with paddle.enable_grad():
                z = x * 3
        assert y.stop_gradient and not z.stop_gradient

        @paddle.no_grad()
        def f(t):
            return t * 4
        assert f(x).stop_gradient
        paddle.set_grad_enabled(False)
        try:
            assert (x * 5).stop_gradient
        finally:
            paddle.set_grad_enabled(True)
        assert paddle.is_grad_enabled()


def test_pylayer_custom_backward_and_saved_tensor():
    a, b = _arrays(8, (3,), (3,))

    def run(paddle):
        class MulClip(paddle.PyLayer):
            @staticmethod
            def forward(ctx, x, y):
                ctx.save_for_backward(x, y)
                return x * y

            @staticmethod
            def backward(ctx, g):
                x, y = ctx.saved_tensor
                return paddle.clip(g * y, -0.1, 0.1), g * x

        x = paddle.to_tensor(a, stop_gradient=False)
        y = paddle.to_tensor(b, stop_gradient=False)
        out = MulClip.apply(x, y)
        (out * 3.0).sum().backward()
        return [out, x.grad, y.grad]
    _both(run)


def test_register_hook_and_retain_grads():
    (a,) = _arrays(9, (4,))

    def run(paddle):
        x = paddle.to_tensor(a, stop_gradient=False)
        seen = []
        h = x.register_hook(lambda g: seen.append(g.numpy()) or g * 2)
        mid = paddle.exp(x)
        mid.retain_grads()
        (mid * mid).sum().backward()
        assert len(seen) == 1
        h.remove()
        return [x.grad, mid.grad]
    _both(run)


def test_register_grad_ready_hook_once_per_leaf_with_the_final_grad():
    from paddle_tpu_torch.autograd import (register_grad_ready_hook,
                                           register_post_backward_hook)
    p = paddle_tpu_torch
    a, b = _arrays(10, (3,), (3,))
    x = p.to_tensor(a, stop_gradient=False)
    w = p.to_tensor(b, stop_gradient=False)
    fired = []
    handles = [register_grad_ready_hook(
        t, lambda t, n=n: fired.append((n, t.grad.numpy().copy())))
        for n, t in (("x", x), ("w", w))]
    done = []
    post = register_post_backward_hook(lambda: done.append(len(fired)))
    y = (x * w).sum() + (x * x).sum() + paddle_tpu_torch.sin(w).sum()
    y.backward()
    assert sorted(n for n, _ in fired) == ["w", "x"] and done == [2]
    final = dict(fired)
    np.testing.assert_allclose(final["x"], x.grad.numpy())
    np.testing.assert_allclose(final["x"], b + 2 * a, rtol=RTOL)
    np.testing.assert_allclose(final["w"], a + np.cos(b), rtol=RTOL)
    for h in handles:
        h.remove()
    post.remove()
    (x * 2).sum().backward()
    assert len(fired) == 2 and done == [2]


def test_functional_vjp_jvp_jacobian_hessian():
    (a,) = _arrays(11, (3,))

    def f(x):
        return x * x * x

    def run(paddle):
        x = paddle.to_tensor(a)
        out, vj = paddle.autograd.vjp(f, x)
        _, jv = paddle.autograd.jvp(f, x)
        jac = paddle.autograd.jacobian(f, x)
        hes = paddle.autograd.hessian(lambda t: (t * t * t).sum(), x)
        return [out, vj, jv, jac, hes]
    _both(run)
