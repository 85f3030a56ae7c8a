"""The port's mixed precision (``paddle_tpu_torch/amp``) and its per-op
seam (``ops/dispatch.py``) against the JAX package's.

- Which dtype each op runs in: the tiny GPT of ``_torch_helpers``
  (2 x 128 tokens) under ``auto_cast`` at O1 and at O2 after
  ``decorate``, in bf16 and fp16; the (op, input dtypes) sequence the
  port's seam sees equals the JAX dispatch's, op by op, over the ops the
  port routes (the JAX package also dispatches reshapes and slices); the
  same for the tiny ERNIE and BERT at O2 fp16, whose LayerNorms run in
  fp32.
- ``GradScaler``: the (scale, good steps, bad steps) trajectory with
  planted infs equals JAX's exactly, a skipped step leaves every
  parameter bit-unchanged, and the bf16 pass-through holds inside an
  ``auto_cast`` block only (outside one the ambient dtype is float32),
  in both packages.
- Three eager O2 fp16 steps of the tiny GPT with a warm-up/cosine
  schedule, ``ClipGradByGlobalNorm(1.0)`` and ``GradScaler(2**15)``: the
  scale trajectory and the learning rates equal JAX's; the losses agree
  at rtol 1e-4 (an eighth of an fp16 ulp of a loss near 4.8: the loss is
  fp32 from fp16 logits; both packages compute in fp16 and round at
  different places, since the port's attention takes the plain K2/K3,
  which accumulate in fp32, and the JAX model its dense fp16 path;
  measured 6e-6). Each fp32 master weight's update over the three steps
  agrees to 1e-2 of its norm (measured at most 2.5e-3): AdamW divides by
  sqrt(v), so a gradient made of rounding noise moves by a whole lr either
  way. That is why the k third of ``qkv_proj.bias`` is left out: its exact
  gradient is zero (a key bias adds one constant to a query's scores),
  and its updates differ by 0.74 of their norm.
- ``FLAGS_check_nan_inf``: the eager seam raises the reference's message
  for the same op, the train step names the same culprits, and
  ``run_steps`` refuses the flag with the reference's message.
- ``check_numerics`` gives the reference's message.

The JAX side takes its dense attention (``PDTPU_PALLAS_INTERPRET`` off).
"""
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp.auto_cast  # noqa: F401
import paddle_tpu.utils.flags as jflags
from _torch_helpers import tiny_models, tiny_text_models, token_batch
from paddle_tpu.jit.train_step import CompiledTrainStep as JaxTrainStep
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import dispatch as pdispatch
from paddle_tpu_torch.utils import flags as pflags

jac = sys.modules["paddle_tpu.amp.auto_cast"]

ROUTED = {"embedding", "add", "layer_norm", "rms_norm", "linear", "matmul",
          "scaled_dot_product_attention", "gelu", "cross_entropy"}


@pytest.fixture(autouse=True)
def dense_jax_attention(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "0")


@pytest.fixture
def nan_check():
    """FLAGS_check_nan_inf on in both packages for the test, then off."""
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    pflags.set_flags({"FLAGS_check_nan_inf": True})
    yield
    paddle.set_flags({"FLAGS_check_nan_inf": False})
    pflags.set_flags({"FLAGS_check_nan_inf": False})


def _batch(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 128, (2, 128)), rng.integers(0, 128, (2, 128))


def _dtype_name(a):
    if a is None:
        return None
    dt = getattr(a, "_value", a).dtype
    return str(dt).replace("torch.", "")


def _recorder(module, monkeypatch, log):
    real = module.maybe_cast_inputs

    def rec(op, args):
        out = real(op, args)
        log.append((op, tuple(_dtype_name(a) for a in out)))
        return out
    monkeypatch.setattr(module, "maybe_cast_inputs", rec)


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_op_dtypes_follow_the_reference(level, dtype, monkeypatch):
    jm, pm = tiny_models()
    if level == "O2":
        jm = paddle.amp.decorate(jm, level="O2", dtype=dtype)
        pm = pamp.decorate(pm, level="O2", dtype=dtype)
    ids, labels = _batch(1)
    jlog, plog = [], []
    _recorder(jac, monkeypatch, jlog)
    _recorder(pdispatch, monkeypatch, plog)
    with paddle.amp.auto_cast(level=level, dtype=dtype):
        _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    with pamp.auto_cast(level=level, dtype=dtype):
        _, ploss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    jseq = [e for e in jlog if e[0] in ROUTED]
    assert {op for op, _ in plog} <= ROUTED
    assert plog == jseq
    # 2 embeddings and their add, 10 ops a block, the last norm, the head
    # and the loss
    assert len(plog) == 3 + 2 * 10 + 3
    # ops with a low-dtype input: O1 the head alone; O2 all but the norms
    # and the loss
    low = {"O1": 1, "O2": 26 - 5 - 1}[level]
    assert sum(any(d == dtype for d in dts) for _, dts in plog) == low
    assert ploss.dtype == torch.float32
    np.testing.assert_allclose(ploss.item(), float(np.asarray(jloss._value)),
                               rtol=2e-2)


@pytest.mark.parametrize("family, head", [
    ("ernie", "ErnieForPretraining"),
    ("bert", "BertForSequenceClassification")])
def test_encoder_op_dtypes_follow_the_reference(family, head, monkeypatch):
    """The tiny ERNIE and BERT of ``_torch_helpers`` at O2 fp16: their
    LayerNorms run in fp32 and everything else in fp16, op by op as in
    the reference."""
    jm, pm = tiny_text_models(family, head)
    jm = paddle.amp.decorate(jm, level="O2", dtype="float16")
    pm = pamp.decorate(pm, level="O2", dtype="float16")
    ids, labels = token_batch(1)
    if family == "bert":
        labels = labels[:, 0].clip(0, 1)
    jlog, plog = [], []
    _recorder(jac, monkeypatch, jlog)
    _recorder(pdispatch, monkeypatch, plog)
    with paddle.amp.auto_cast(level="O2", dtype="float16"):
        jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))[-1]
    with pamp.auto_cast(level="O2", dtype="float16"):
        ploss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))[-1]
    assert {op for op, _ in plog} <= ROUTED
    assert plog == [e for e in jlog if e[0] in ROUTED]
    norms = [dts for op, dts in plog if op == "layer_norm"]
    assert len(norms) == 1 + 2 * 2 + (family == "ernie")
    assert all(d == "float32" for dts in norms for d in dts)
    # fp16 throughout, so the losses agree to fp16's rounding
    np.testing.assert_allclose(ploss.item(), float(np.asarray(jloss._value)),
                               rtol=2e-2)


def test_amp_state_and_passthrough_rule():
    assert not pamp.is_auto_cast_enabled()
    assert pamp.get_amp_dtype() == paddle.amp.get_amp_dtype() == "float32"
    with pamp.auto_cast(dtype="bfloat16"), \
            paddle.amp.auto_cast(dtype="bfloat16"):
        assert pamp.is_auto_cast_enabled()
        assert pamp.get_amp_dtype() == paddle.amp.get_amp_dtype() \
            == "bfloat16"
        loss = torch.tensor(3.0)
        # bf16 passes through inside the block, in both packages
        assert pamp.GradScaler(init_loss_scaling=8.0).scale(loss) is loss
        jl = paddle.to_tensor(np.float32(3.0))
        assert paddle.amp.GradScaler(init_loss_scaling=8.0).scale(jl) is jl
    # outside a block the ambient dtype is float32: the scaler scales
    assert float(pamp.GradScaler(init_loss_scaling=8.0).scale(
        torch.tensor(3.0))) == float(np.asarray(paddle.amp.GradScaler(
            init_loss_scaling=8.0).scale(
                paddle.to_tensor(np.float32(3.0)))._value)) == 24.0
    with pamp.auto_cast(level="O0"):
        assert not pamp.is_auto_cast_enabled()
    assert pamp.amp_guard is pamp.auto_cast
    with pytest.raises(ValueError):
        pamp.auto_cast(level="O3")


def _scaler_run(pkg, steps):
    """Trajectory of a 4 -> 1 linear model under ``GradScaler`` in fp16
    amp: [(scale, good, bad, params changed)] per step; x of steps 2, 3
    and 6 hold an inf, so their gradients do."""
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((4, 1)).astype(np.float32)
    xs = rng.standard_normal((steps, 3, 4)).astype(np.float32)
    xs[2, 0, 1] = np.inf
    xs[3, 1, 0] = -np.inf
    xs[6, 2, 3] = np.inf
    out = []
    if pkg == "jax":
        lin = paddle.nn.Linear(4, 1)
        lin.weight.set_value(w0)
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=lin.parameters())
        scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0,
                                       incr_every_n_steps=2)
        get = lambda: [np.asarray(p._value).copy()  # noqa: E731
                       for p in lin.parameters()]
        for x in xs:
            before = get()
            with paddle.amp.auto_cast(dtype="float16"):
                loss = lin(paddle.to_tensor(x)).sum()
            scaler.scale(loss).backward()
            scaler.step(opt)
            opt.clear_grad()
            changed = any((a != b).any() for a, b in zip(before, get()))
            out.append((scaler._scale, scaler._good_steps,
                        scaler._bad_steps, changed))
        return out, get()
    from paddle_tpu_torch import nn as pnn
    lin = pnn.Linear(4, 1, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0))
    opt = port_opt.SGD(learning_rate=0.1, parameters=lin.parameters())
    scaler = pamp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
    get = lambda: [p.detach().numpy().copy()  # noqa: E731
                   for p in lin.parameters()]
    for x in xs:
        before = get()
        with pamp.auto_cast(dtype="float16"):
            loss = lin(torch.from_numpy(x)).sum()
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        changed = any((a != b).any() for a, b in zip(before, get()))
        out.append((scaler._scale, scaler._good_steps, scaler._bad_steps,
                    changed))
    return out, get()


def test_grad_scaler_trajectory_matches_jax():
    port, p_params = _scaler_run("port", 9)
    ref, j_params = _scaler_run("jax", 9)
    assert port == ref
    # the inf steps were skipped (parameters bit-unchanged) and halved the
    # scale; two good steps in a row doubled it
    assert [c for *_, c in port] == [True, True, False, False, True, True,
                                     False, True, True]
    assert [s for s, *_ in port] == [1024.0, 2048.0, 1024.0, 512.0, 512.0,
                                     1024.0, 512.0, 512.0, 1024.0]
    for a, b in zip(p_params, j_params):
        np.testing.assert_allclose(a, b.reshape(a.shape), rtol=1e-6)


def test_grad_scaler_unscale_keeps_dtypes_and_state_dict():
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.float16))
    p.grad = torch.full((3,), 64.0, dtype=torch.float16)
    opt = port_opt.SGD(learning_rate=0.0, parameters=[p])
    scaler = pamp.GradScaler(init_loss_scaling=2.0 ** 15)
    with pamp.auto_cast(dtype="float16"):
        scaler.unscale_(opt)
    assert p.grad.dtype == torch.float16
    assert torch.equal(p.grad, torch.full((3,), 2.0 ** -9,
                                          dtype=torch.float16))
    state = scaler.state_dict()
    again = pamp.GradScaler()
    again.load_state_dict(state)
    assert again.get_init_loss_scaling() == 2.0 ** 15
    assert pamp.GradScaler(enable=False).scale(torch.tensor(2.0)) == 2.0


def _o2_fp16_run(pkg):
    """Three eager O2 fp16 steps of the tiny GPT, the upstream recipe."""
    jm, pm = tiny_models(seed=4)
    batches = [_batch(10 + i) for i in range(3)]
    if pkg == "jax":
        lr = paddle.optimizer.lr
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(5e-3, 1000), 2, 0.0,
                                5e-3)
        opt = paddle.optimizer.AdamW(
            learning_rate=sched, parameters=jm.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        jm, opt = paddle.amp.decorate(jm, opt, level="O2", dtype="float16")
        scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 15)
        out = []
        for ids, labels in batches:
            with paddle.amp.auto_cast(level="O2", dtype="float16"):
                _, loss = jm(paddle.to_tensor(ids),
                             labels=paddle.to_tensor(labels))
            scaler.scale(loss).backward()
            scaler.step(opt)
            opt.clear_grad()
            out.append((float(np.asarray(loss._value)), scaler._scale,
                        opt.get_lr()))
            sched.step()
        masters = [np.asarray(opt._accumulators[id(p)]["master_weight"])
                   for p in jm.parameters()]
        return out, masters
    plr = port_opt.lr
    sched = plr.LinearWarmup(plr.CosineAnnealingDecay(5e-3, 1000), 2, 0.0,
                             5e-3)
    opt = port_opt.AdamW(learning_rate=sched, parameters=pm.parameters(),
                         grad_clip=ClipGradByGlobalNorm(1.0))
    pm, opt = pamp.decorate(pm, opt, level="O2", dtype="float16")
    scaler = pamp.GradScaler(init_loss_scaling=2.0 ** 15)
    out = []
    for ids, labels in batches:
        with pamp.auto_cast(level="O2", dtype="float16"):
            _, loss = pm(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels))
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        out.append((loss.item(), scaler._scale, opt.get_lr()))
        sched.step()
    assert all(p.dtype == torch.float16 for p in pm.parameters())
    masters = [opt._accumulators[id(p)]["master_weight"].numpy()
               for p in pm.parameters()]
    return out, masters


def test_eager_o2_fp16_steps_match_jax():
    port, p_masters = _o2_fp16_run("port")
    ref, j_masters = _o2_fp16_run("jax")
    assert [(s, lr) for _, s, lr in port] == [(s, lr) for _, s, lr in ref]
    # warm-up 0 -> 2.5e-3, then the cosine's first step below 5e-3
    lrs = [lr for *_, lr in port]
    assert lrs[:2] == [0.0, 2.5e-3] and 0.99 * 5e-3 < lrs[2] < 5e-3
    np.testing.assert_allclose([l for l, *_ in port], [l for l, *_ in ref],
                               rtol=1e-4)
    _, pm = tiny_models(seed=4)
    assert len(p_masters) == len(j_masters)
    for (name, p0), a, b in zip(pm.named_parameters(), p_masters,
                                j_masters):
        da, db = a - p0.detach().numpy(), b - p0.detach().numpy()
        if name.endswith("qkv_proj.bias"):
            keep = np.r_[0:128, 256:384]   # the q and v thirds
            da, db = da[keep], db[keep]
        assert np.linalg.norm(da - db) <= 1e-2 * np.linalg.norm(db), name


def test_eager_nan_check_names_the_op(nan_check):
    x = np.ones((2, 3), np.float32)
    x[0, 1] = np.inf
    x[1, 2] = np.nan
    w = np.ones((3, 4), np.float32)
    with pytest.raises(RuntimeError) as jerr:
        paddle.nn.functional.linear(paddle.to_tensor(x), paddle.to_tensor(w))
    with pytest.raises(RuntimeError) as perr:
        PF.linear(torch.from_numpy(x), torch.from_numpy(w))
    assert str(perr.value) == str(jerr.value)
    assert "op 'linear' output 0 (shape (2, 4), dtype float32)" in \
        str(perr.value)


def _culprits(message, names):
    """Positions (0 the loss, i + 1 trainable i) a message names."""
    listed = message.rsplit(": ", 1)[1].split(", ")
    return sorted(0 if n == "loss" else names.index(n) + 1 for n in listed)


def test_train_step_nan_check_names_the_culprits(nan_check):
    jm, pm = tiny_models()
    ids, labels = _batch(2)
    # an inf in the last norm's weight: the loss and every gradient that
    # flows through it go non-finite, the embeddings' too
    jw = jm.gpt.ln_f.weight
    bad = np.asarray(jw._value).copy()
    bad[5] = np.inf
    jw.set_value(bad)
    with torch.no_grad():
        pm.gpt.ln_f.weight[5] = float("inf")
    jstep = JaxTrainStep(lambda i, lb: jm(i, labels=lb)[1], jm,
                         paddle.optimizer.SGD(learning_rate=0.1,
                                              parameters=jm.parameters()),
                         donate=False)
    pstep = CompiledTrainStep(lambda i, lb: pm(i, labels=lb)[1], pm,
                              port_opt.SGD(learning_rate=0.1,
                                           parameters=pm.parameters()))
    with pytest.raises(RuntimeError) as jerr:
        jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))
    before = [p.detach().clone() for p in pm.parameters()]
    with pytest.raises(RuntimeError) as perr:
        pstep(torch.from_numpy(ids), torch.from_numpy(labels))
    jmsg, pmsg = str(jerr.value), str(perr.value)
    assert pmsg.startswith("FLAGS_check_nan_inf: non-finite values in "
                           "compiled train step (step 1): loss")
    jnames = [getattr(p, "name", None) or f"param_{i}"
              for i, p in enumerate(jstep.trainable)]
    pnames = [f"param_{i}" for i in range(len(pstep.trainable))]
    assert _culprits(pmsg, pnames) == _culprits(jmsg, jnames)
    # the step raised before its update: every parameter kept its bits
    for b, p in zip(before, pm.parameters()):
        assert torch.equal(b, p.detach())
    # run_steps refuses the flag, with the reference's message, and
    # changes nothing
    block = [np.stack([a, a]) for a in (ids, labels)]
    with pytest.raises(RuntimeError) as jerr:
        jstep.run_steps(*map(paddle.to_tensor, block))
    with pytest.raises(RuntimeError) as perr:
        pstep.run_steps(*map(torch.from_numpy, block))
    assert str(perr.value) == str(jerr.value)
    for b, p in zip(before, pm.parameters()):
        assert torch.equal(b, p.detach())


def test_check_numerics_matches_jax():
    x = np.array([1.0, np.nan, np.inf, np.nan], np.float32)
    with pytest.raises(RuntimeError) as jerr:
        paddle.amp.debugging.check_numerics(paddle.to_tensor(x), "fc",
                                            "out")
    with pytest.raises(RuntimeError) as perr:
        pamp.debugging.check_numerics(torch.from_numpy(x), "fc", "out")
    assert str(perr.value) == str(jerr.value) == \
        "check_numerics: fc output 'out' contains 2 nan / 1 inf values"
    ok = torch.ones(3)
    assert pamp.debugging.check_numerics(ok) is ok
    ints = torch.arange(3)
    assert pamp.debugging.check_numerics(ints) is ints


def test_tensor_checker_sets_the_flag():
    try:
        pamp.debugging.enable_tensor_checker(
            pamp.debugging.TensorCheckerConfig())
        assert pflags.get_flags("FLAGS_check_nan_inf") == {
            "FLAGS_check_nan_inf": True}
        with pytest.raises(RuntimeError, match="op 'gelu'"):
            PF.gelu(torch.tensor([float("nan")]))
    finally:
        pamp.debugging.disable_tensor_checker()
    assert not pflags.get_flag("FLAGS_check_nan_inf")
    assert PF.gelu(torch.tensor([float("nan")])).isnan().all()
    assert not jflags.get_flag("FLAGS_check_nan_inf")
