"""The ``paddle.*`` Tensor surface, held against both packages: each
case of ``test_tensor_basic.py`` and of ``test_tensor_methods_tail.py``'s
Tensor-method tail runs on the reference (``paddle_tpu``) and on the
port (``paddle_tpu_torch``, on the CPU), and returns what it computed;
the two packages' results must be equal (exactly: these are small exact
values). Then the port's own rules: the device rule, bf16 ``numpy()``,
writes to a leaf that requires grad, and the reference's promotions and
Paddle meanings."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from _torch_ops_sweep import on_cpu  # noqa: F401  (autouse fixture)

PACKAGES = {"reference": paddle_tpu, "port": paddle_tpu_torch}


def _np(t):
    return np.asarray(t.numpy())


def case_to_tensor_dtypes(paddle):
    assert paddle.to_tensor([1, 2]).dtype == paddle.int64
    assert paddle.to_tensor([1.0, 2.0]).dtype == paddle.float32
    assert paddle.to_tensor(np.float64([1.0])).dtype == paddle.float64
    assert paddle.to_tensor(True).dtype == paddle.bool
    t = paddle.to_tensor([1, 2], dtype="float16")
    assert t.dtype == paddle.float16
    return [str(t.dtype), _np(t)]


def case_dtype_compare_spellings(paddle):
    t = paddle.ones([2], dtype="float32")
    assert t.dtype == "float32"
    assert t.dtype == np.float32
    assert t.dtype == paddle.float32
    return [str(t.dtype)]


def case_creation_ops(paddle):
    assert paddle.zeros([2, 3]).shape == [2, 3]
    assert paddle.ones([4]).numpy().tolist() == [1, 1, 1, 1]
    assert paddle.full([2], 7).numpy().tolist() == [7, 7]
    assert paddle.arange(5).numpy().tolist() == [0, 1, 2, 3, 4]
    assert paddle.arange(1, 2, 0.5).dtype == paddle.float32
    e = paddle.eye(3)
    assert float(paddle.sum(e).numpy()) == 3.0
    assert paddle.linspace(0, 1, 5).shape == [5]
    z = paddle.zeros_like(paddle.ones([2, 2], dtype="int32"))
    assert z.dtype == paddle.int32
    return [_np(paddle.full([2], 7)), _np(paddle.arange(1, 2, 0.5)),
            _np(paddle.linspace(0, 1, 5)), str(z.dtype)]


def case_numpy_roundtrip_item(paddle):
    t = paddle.to_tensor([[1.5]])
    assert t.item() == 1.5
    assert t.numpy().shape == (1, 1)
    assert float(t) == 1.5
    return [t.item()]


def case_getitem_setitem(paddle):
    x = paddle.to_tensor(np.arange(12).reshape(3, 4).astype(np.float32))
    assert x[0].numpy().tolist() == [0, 1, 2, 3]
    assert x[1, 2].item() == 6
    assert x[:, 1].numpy().tolist() == [1, 5, 9]
    assert x[::2].shape == [2, 4]
    x[0, 0] = 100.0
    assert x[0, 0].item() == 100.0
    x[1] = 0.0
    assert x[1].numpy().sum() == 0
    m = x > 50
    sel = x[m]
    assert sel.numpy().tolist() == [100.0]
    idx = paddle.to_tensor([0, 2])
    assert x[idx].shape == [2, 4]
    return [_np(x), _np(x[idx]), _np(x[..., None, 1:3])]


def case_inplace_ops(paddle):
    x = paddle.ones([3])
    x.add_(paddle.ones([3]))
    assert x.numpy().tolist() == [2, 2, 2]
    x.scale_(0.5)
    assert x.numpy().tolist() == [1, 1, 1]
    return [_np(x)]


def case_operators(paddle):
    x = paddle.to_tensor([2.0, 4.0])
    y = paddle.to_tensor([1.0, 2.0])
    assert (x + y).numpy().tolist() == [3, 6]
    assert (x - y).numpy().tolist() == [1, 2]
    assert (x * y).numpy().tolist() == [2, 8]
    assert (x / y).numpy().tolist() == [2, 2]
    assert (x ** 2).numpy().tolist() == [4, 16]
    assert (-x).numpy().tolist() == [-2, -4]
    assert (x > y).numpy().tolist() == [True, True]
    assert (x == x).numpy().all()
    assert (2 * x).numpy().tolist() == [4, 8]
    assert (1 / y).numpy().tolist() == [1.0, 0.5]
    return [_np(x @ y), _np(2 ** y), _np(x % 3), _np(x // 3)]


def case_backward_accumulate_and_clear(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 2).sum().backward()
    assert x.grad.numpy().tolist() == [2, 2]
    (x * 3).sum().backward()
    assert x.grad.numpy().tolist() == [5, 5]
    x.clear_grad()
    assert x.grad is None
    return []


def case_no_grad(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with paddle.no_grad():
        y = x * 2
    assert y.stop_gradient
    y2 = x * 2
    assert not y2.stop_gradient
    return []


def case_detach(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = (x * 2).detach()
    assert y.stop_gradient
    assert y.grad_node is None
    return [_np(y)]


def case_retain_graph(paddle):
    x = paddle.to_tensor([3.0], stop_gradient=False)
    y = x * x
    y.backward(retain_graph=True)
    y.backward()
    assert x.grad.numpy().tolist() == [12.0]
    z = x * x
    z.backward()
    with pytest.raises(RuntimeError):
        z.backward()
    return [_np(x.grad)]


def case_paddle_grad_api(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    y = x ** 3
    (g,) = paddle.grad(y, x)
    np.testing.assert_allclose(g.numpy(), [12.0], rtol=1e-6)
    assert x.grad is None
    return [_np(g)]


def case_pylayer(paddle):
    class Double(paddle.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            return grad * 2

    x = paddle.to_tensor([3.0], stop_gradient=False)
    y = Double.apply(x)
    y.sum().backward()
    assert x.grad.numpy().tolist() == [2.0]
    return [_np(y)]


def case_multi_output_op_grads(paddle):
    x = paddle.to_tensor(np.random.default_rng(0).random(6)
                         .astype(np.float32), stop_gradient=False)
    a, b = paddle.split(x, 2)
    (a.sum() * 2 + b.sum() * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [2, 2, 2, 3, 3, 3],
                               rtol=1e-6)
    return [_np(x.grad)]


def case_topk_grad(paddle):
    x = paddle.to_tensor([1.0, 5.0, 3.0, 2.0], stop_gradient=False)
    vals, idx = paddle.topk(x, 2)
    assert vals.numpy().tolist() == [5.0, 3.0]
    assert idx.numpy().tolist() == [1, 2]
    vals.sum().backward()
    assert x.grad.numpy().tolist() == [0, 1, 1, 0]
    return [_np(idx), str(idx.dtype)]


def case_seed_determinism(paddle):
    paddle.seed(7)
    a = paddle.rand([4])
    paddle.seed(7)
    b = paddle.rand([4])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    return [str(a.dtype), a.shape]


def case_set_device(paddle):
    assert paddle.get_device() == "cpu"
    paddle.set_device("cpu")
    t = paddle.ones([1])
    assert t.place.device_type == "cpu"
    return [t.place.device_type]


def case_inplace_unary(paddle):
    t = paddle.to_tensor(np.array([1.44, 2.25], np.float32))
    assert t.sqrt_() is t
    np.testing.assert_allclose(t.numpy(), [1.2, 1.5])
    t2 = paddle.to_tensor(np.array([2.7], np.float32))
    t2.floor_()
    np.testing.assert_allclose(t2.numpy(), [2.0])
    return [_np(t), _np(t2)]


def case_lerp_(paddle):
    t = paddle.to_tensor(np.array([0.0], np.float32))
    t.lerp_(paddle.to_tensor(np.array([10.0], np.float32)), 0.3)
    np.testing.assert_allclose(t.numpy(), [3.0])
    return [_np(t)]


def case_masked_fill_(paddle):
    m = paddle.to_tensor(np.zeros((2, 2), np.float32))
    m.masked_fill_(paddle.to_tensor(
        np.array([[True, False], [False, True]])), 7.0)
    np.testing.assert_array_equal(m.numpy(), [[7, 0], [0, 7]])
    return [_np(m)]


def case_dtype_casts(paddle):
    assert "bool" in str(paddle.to_tensor([1.0]).bool().dtype)
    assert "float32" in str(paddle.to_tensor([1]).float().dtype)
    assert "int32" in str(paddle.to_tensor([1.5]).int().dtype)
    assert "int64" in str(paddle.to_tensor([1.5]).long().dtype)
    return [_np(paddle.to_tensor([1.5, -1.5]).int())]


def case_size_metadata(paddle):
    t = paddle.to_tensor(np.zeros((2, 3), np.float32))
    assert t.element_size() == 4 and t.nbytes == 24
    assert t.ndimension() == 2
    return [t.size, t.ndim, len(t)]


def case_gradient(paddle):
    x = paddle.to_tensor(np.array([1.0], np.float32), stop_gradient=False)
    (x * 3).backward()
    np.testing.assert_allclose(x.gradient(), [3.0])
    return [x.gradient()]


def case_promotion(paddle):
    """The reference's promotions: an int tensor with a Python float is
    float32, int32 with int64 is int64, a bool sum is int64, int / int
    and sqrt(int) are float32, a mean of ints is float32, argmax int64."""
    i32 = paddle.to_tensor(np.array([1, 2, 3], np.int32))
    i64 = paddle.to_tensor([4, 5, 6])
    b = paddle.to_tensor([True, False, True])
    outs = [i32 * 2.5, i32 + i64, i32 + 1, paddle.sum(b), b + b, i32 / i32,
            paddle.sqrt(i32), paddle.mean(i32), paddle.argmax(i32),
            paddle.sum(i32), paddle.cumsum(i32), paddle.max(i32),
            i32 + True]
    return [(str(o.dtype), _np(o)) for o in outs]


def case_paddle_meanings(paddle):
    """reshape with -1, transpose(perm), split by sections (one -1),
    gather along an axis, floor division and % of negative operands,
    clip of an int tensor (float64 in the reference), int64 indices."""
    x = paddle.to_tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    a, b = paddle.split(x, [1, -1], axis=2)
    n = paddle.to_tensor([-7, 7, -8])
    d = paddle.to_tensor([2, -2, 3])
    outs = [paddle.reshape(x, [-1, 4]), paddle.transpose(x, [2, 0, 1]),
            a, b, paddle.gather(x, paddle.to_tensor([2, 0]), axis=1),
            paddle.floor_divide(n, d), n % d, paddle.clip(n, -3, 5),
            paddle.argsort(x, axis=1), x.sum(axis=[0, 2]),
            x.transpose([1, 0, 2]).reshape([3, -1])]
    return [(str(o.dtype), _np(o)) for o in outs]


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, (a.dtype, np.asarray(b).dtype)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_case(case, package):
    CASES[case](PACKAGES[package])


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_packages_agree(case):
    _same(CASES[case](paddle_tpu_torch), CASES[case](paddle_tpu))


# -- the port's own rules ----------------------------------------------------
def test_default_place_is_the_card_and_raises_without_one(monkeypatch):
    from paddle_tpu_torch.framework import place
    monkeypatch.setattr(place, "_current_place", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert paddle_tpu_torch.get_device() == "gpu:0"
    for make in (lambda: paddle_tpu_torch.to_tensor([1.0]),
                 lambda: paddle_tpu_torch.ones([2]),
                 lambda: paddle_tpu_torch.rand([2])):
        with pytest.raises(RuntimeError, match="set_device"):
            make()
    t = paddle_tpu_torch.to_tensor([1.0], place=paddle_tpu_torch.CPUPlace())
    assert t.place == paddle_tpu_torch.CPUPlace()


def test_places_and_queries():
    p = paddle_tpu_torch
    assert p.set_device("gpu:1") == p.CUDAPlace(1)
    assert p.get_device() == "gpu:1"
    assert p.set_device("cuda:0") == p.CUDAPlace(0)
    assert p.set_device("cpu") == p.CPUPlace()
    assert p.is_compiled_with_tpu() is False
    assert p.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert p.device_count() == torch.cuda.device_count()
    assert p.CUDAPlace(2).torch_device if torch.cuda.is_available() else 1
    assert not hasattr(p, "TPUPlace")


def test_bf16_numpy_is_float32():
    t = paddle_tpu_torch.to_tensor([1.0, 2.5]).astype("bfloat16")
    assert t.dtype == paddle_tpu_torch.bfloat16
    a = t.numpy()
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, [1.0, 2.5])


def test_write_to_a_leaf_that_requires_grad():
    """torch refuses an in-place write to such a leaf; the surface
    replaces the payload as the reference does, the gradient flows
    through the written value, and a graph that saved the old value is
    untouched (no version-counter error)."""
    vals = []
    for paddle in (paddle_tpu, paddle_tpu_torch):
        x = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        x[1] = 10.0
        x.add_(paddle.to_tensor([1.0, 1.0, 1.0]))
        vals.append(x.numpy().tolist())
    assert vals[0] == vals[1] == [2.0, 11.0, 4.0]
    x = paddle_tpu_torch.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    leaf = x._value
    y = x * x                        # saves the old x
    x[1] = 10.0
    x.add_(paddle_tpu_torch.to_tensor([1.0, 1.0, 1.0]))
    (y.sum() + (x * 2).sum()).backward()
    # d/dx0 of x0^2 + 2 (x0 + 1) and of x2; x1 was overwritten
    assert leaf.grad.tolist() == [4.0, 4.0, 8.0]
    a = paddle_tpu_torch.to_tensor([1.0, 2.0], stop_gradient=False)
    w = paddle_tpu_torch.to_tensor([5.0], stop_gradient=False)
    b = a * 1.0
    b[0] = w * 3.0
    b.sum().backward()
    assert w.grad.numpy().tolist() == [3.0]
    assert a.grad.numpy().tolist() == [0.0, 1.0]


def test_zero_and_fill_keep_a_leaf_and_its_grad():
    x = paddle_tpu_torch.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 2).sum().backward()
    x.zero_()
    assert x.is_leaf and not x.stop_gradient
    assert x.numpy().tolist() == [0.0, 0.0]
    assert x.grad.numpy().tolist() == [2.0, 2.0]
    x.fill_(3.0)
    assert x.numpy().tolist() == [3.0, 3.0]


def test_int_tensor_stop_gradient_is_a_flag():
    t = paddle_tpu_torch.to_tensor([1, 2], stop_gradient=False)
    assert t.stop_gradient is False and t.grad is None
    t.stop_gradient = True
    assert t.stop_gradient


def test_ops_on_torch_tensors_stay_torch():
    a = torch.tensor([1.0, 2.0])
    out = paddle_tpu_torch.add(a, a)
    assert type(out) is torch.Tensor
    out = paddle_tpu_torch.exp(a)
    assert type(out) is torch.Tensor
    mixed = paddle_tpu_torch.add(paddle_tpu_torch.to_tensor([1.0, 1.0]), a)
    assert isinstance(mixed, paddle_tpu_torch.Tensor)


def test_dtype_objects():
    p = paddle_tpu_torch
    assert p.float32 == torch.float32 and p.float32 == "float32"
    assert p.bfloat16.np_dtype is None and str(p.bfloat16) == \
        "paddle.bfloat16"
    assert p.iinfo(p.int32).max == 2 ** 31 - 1
    assert p.finfo("bfloat16").eps == 2 ** -7
    p.set_default_dtype("float64")
    try:
        assert p.to_tensor([1.5]).dtype == p.float64
    finally:
        p.set_default_dtype("float32")
    with pytest.raises(TypeError):
        p.set_default_dtype("int32")


def test_create_parameter_defaults():
    w = paddle_tpu_torch.create_parameter([4, 6])
    b = paddle_tpu_torch.create_parameter([6], is_bias=True)
    assert not w.stop_gradient and isinstance(w, paddle_tpu_torch.Parameter)
    assert float(abs(w).max()) <= (6 / 10) ** 0.5
    assert b.numpy().tolist() == [0.0] * 6


def test_the_port_exports_the_reference_surface():
    """Every name ``paddle_tpu/__init__.py`` exports from its tensor, ops
    and autograd layer (the hoisted ops too), except ``TPUPlace``, which
    becomes ``CUDAPlace``; and each op is a ``Tensor`` method as well."""
    from paddle_tpu.ops import collect_public_ops as reference_ops
    from paddle_tpu_torch.ops import collect_public_ops as port_ops
    names = [
        "DType", "bfloat16", "float16", "float32", "float64", "int8",
        "int16", "int32", "int64", "uint8", "bool", "complex64",
        "complex128", "set_default_dtype", "get_default_dtype", "seed",
        "get_rng_state", "set_rng_state", "iinfo", "finfo",
        "get_cuda_rng_state", "set_cuda_rng_state", "CPUPlace", "XPUPlace",
        "CUDAPlace", "CUDAPinnedPlace", "IPUPlace", "CustomPlace",
        "set_device", "get_device", "is_compiled_with_cuda",
        "is_compiled_with_xpu", "is_compiled_with_tpu",
        "is_compiled_with_cinn", "is_compiled_with_rocm",
        "is_compiled_with_ipu", "is_compiled_with_custom_device",
        "device_count", "Tensor", "Parameter", "to_tensor",
        "create_parameter", "no_grad", "enable_grad", "set_grad_enabled",
        "is_grad_enabled", "grad", "PyLayer"]
    for n in names:
        assert hasattr(paddle_tpu, n), n
        assert hasattr(paddle_tpu_torch, n), n
    assert sorted(port_ops()) == sorted(reference_ops())
    for n in port_ops():
        assert hasattr(paddle_tpu_torch, n), n
        assert hasattr(paddle_tpu_torch.Tensor, n), n


def test_reshape_zero_copies_the_dimension():
    """Upstream Paddle's 0 in ``reshape`` keeps that dimension (the
    reference's jnp.reshape refuses it: ROADMAP C)."""
    x = paddle_tpu_torch.ones([2, 3, 4])
    assert paddle_tpu_torch.reshape(x, [0, -1]).shape == [2, 12]
    assert x.reshape([0, 0, 2, 2]).shape == [2, 3, 2, 2]


def test_pylayer_keyword_arguments_and_tuple_outputs():
    class ScaleBoth(paddle_tpu_torch.PyLayer):
        @staticmethod
        def forward(ctx, x, factor=1.0):
            ctx.factor = factor
            return x * factor, x + 0.0

        @staticmethod
        def backward(ctx, ga, gb):
            return ga * ctx.factor + gb

    x = paddle_tpu_torch.to_tensor([1.0, 2.0], stop_gradient=False)
    a, b = ScaleBoth.apply(x, factor=3.0)
    (a + b).sum().backward()
    assert x.grad.numpy().tolist() == [4.0, 4.0]
