"""Checkpoints of the port against the JAX package's: ``Layer.state_dict``
and ``set_state_dict`` (``nn/layer/layers.py``), the optimizer's state
(``optimizer/optimizer.py``), ``Model.save``/``load`` and
``ModelCheckpoint`` (``hapi/``), ``distributed.checkpoint`` and the
elastic checkpoint lifecycle (``distributed/``).

- ``state_dict`` keys equal the reference's, in order, for the tiny GPT
  (tied and untied), ERNIE, BERT and ResNet-18; ``set_state_dict``
  reports the same missing and unexpected keys, raises on a shape
  mismatch as the reference does, writes in place (each parameter keeps
  its identity and dtype).
- Resume: the tiny GPT at O0 fp32 through ``CompiledTrainStep``, 2 steps,
  ``paddle.save``, a model built from another seed, ``paddle.load``, 2
  more steps, equals 4 uninterrupted steps bit for bit: losses,
  parameters and every AdamW accumulator (a resume whose moments did not
  load raises nothing, so they are compared). Across packages: the
  reference trains 2 steps and saves; the port loads its files and runs 2
  more against the reference's own 2 more, at ``test_torch_train_step``'s
  fp32 bounds (losses rtol 1e-5, parameters atol 3e-3: within 3 steps of
  lr), the loaded state itself exactly.
- ``Model.save``/``load`` and ``ModelCheckpoint``'s files on LeNet.
- The six cases of ``tests/test_dist_checkpoint.py`` and the two async
  cases of ``tests/test_dcn_async_ckpt.py`` on the port (the port has no
  mesh: the reshard case loads into destinations of other dtypes and
  devices, which keep theirs); a checkpoint the JAX package wrote sharded
  over the session's 8 CPU devices loads whole, fp32 and bf16, exactly.
- The elastic lifecycle (``checkpoint_path``, ``mark_complete``,
  ``gc_checkpoints``, ``restart_count``, the preemption hook) against the
  reference's functions on the same directories.
"""
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from _torch_helpers import jax_state, tiny_models, tiny_text_models
from _torch_ops_sweep import on_cpu  # noqa: F401  (autouse: the CPU place)
from paddle_tpu.distributed import checkpoint as jdck
from paddle_tpu.distributed import elastic as jelastic
from paddle_tpu.jit.train_step import CompiledTrainStep as JaxTrainStep
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.distributed import checkpoint as dck
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi.callbacks import ModelCheckpoint
from paddle_tpu_torch.jit import CompiledTrainStep
from paddle_tpu_torch.text import gpt
from paddle_tpu_torch.vision import models

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def dense_jax_attention(monkeypatch):
    monkeypatch.setenv("PDTPU_PALLAS_INTERPRET", "0")


def _resnet18_pair():
    from paddle_tpu.vision.models import resnet18 as jresnet18
    jm = jresnet18(num_classes=10)
    pm = models.resnet18(num_classes=10, device="cpu")
    load_jax_state(pm, jax_state(jm))
    return jm, pm


MODELS = {
    "gpt_tied": lambda: tiny_models(tied=True),
    "gpt_untied": lambda: tiny_models(tied=False),
    "ernie": lambda: tiny_text_models("ernie", "ErnieForPretraining"),
    "bert": lambda: tiny_text_models("bert",
                                     "BertForSequenceClassification"),
    "resnet18": _resnet18_pair,
}


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_keys_equal_the_reference_in_order(name):
    jm, pm = MODELS[name]()
    jsd, psd = jm.state_dict(), pm.state_dict()
    assert list(psd) == list(jsd)
    for k, v in psd.items():
        assert tuple(v.shape) == tuple(jsd[k].shape), k
        np.testing.assert_array_equal(v.numpy(), np.asarray(jsd[k]._value),
                                      err_msg=k)


def test_set_state_dict_reports_and_refuses_as_the_reference():
    jm, pm = tiny_models()
    params = {n: p for n, p in pm.named_parameters()}
    ids = {n: id(p) for n, p in params.items()}
    state = {k: v.numpy() + 1.0 for k, v in pm.state_dict().items()}
    dropped = "gpt.ln_f.bias"
    del state[dropped]
    state["not.a.key"] = np.zeros(3, np.float32)
    jstate = {k: jpaddle.to_tensor(v) for k, v in state.items()}
    got = pm.set_state_dict({k: paddle.to_tensor(v)
                             for k, v in state.items()})
    want = jm.set_state_dict(jstate)
    assert got == want == ([dropped], ["not.a.key"])
    for n, p in pm.named_parameters():
        assert id(p) == ids[n] and p.dtype == torch.float32
        if n != dropped:
            np.testing.assert_array_equal(p.detach().numpy(), state[n])
    bad = {"gpt.ln_f.weight": np.zeros((3,), np.float32)}
    with pytest.raises(ValueError, match="shape mismatch"):
        jm.set_state_dict({k: jpaddle.to_tensor(v) for k, v in bad.items()})
    with pytest.raises(ValueError, match="shape mismatch"):
        pm.set_state_dict(bad)
    # set_dict and load_dict are the same call; a bf16 layer stays bf16
    assert pnn.Linear.set_dict is pnn.Linear.set_state_dict
    assert pnn.Linear.load_dict is pnn.Linear.set_state_dict
    lin = pnn.Linear(4, 3, device="cpu", dtype=torch.bfloat16)
    src = np.arange(12, dtype=np.float32).reshape(4, 3)
    lin.set_state_dict({"weight": src, "bias": np.ones(3, np.float32)})
    assert lin.weight.dtype == torch.bfloat16
    assert torch.equal(lin.weight.float(), torch.from_numpy(src))


def test_state_dict_leaves_out_non_persistable_buffers():
    lin = pnn.Linear(2, 2, device="cpu")
    lin.register_buffer("scratch", torch.zeros(2), persistent=False)
    lin.register_buffer("kept", torch.ones(2))
    assert list(lin.state_dict()) == ["weight", "bias", "kept"]
    # torch's own recursion (a plain Module above a Layer) still works
    holder = torch.nn.ModuleDict({"lin": lin})
    assert list(holder.state_dict()) == ["lin.weight", "lin.bias",
                                         "lin.kept"]


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 128, (2, 128))),
            torch.from_numpy(rng.integers(0, 128, (2, 128))))


def _port_gpt(seed):
    kw = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=256, dropout=0.0)
    model = gpt.GPTForPretraining(gpt.GPTConfig(**kw), device="cpu",
                                  seed=seed)
    sched = popt.lr.CosineAnnealingDecay(1e-3, 8)
    opt = popt.AdamW(learning_rate=sched, parameters=model.parameters())
    return model, opt, sched


def _run(model, opt, sched, batches):
    step = CompiledTrainStep(lambda i, lb: model(i, labels=lb)[1], model,
                             opt)
    losses, lrs = [], []
    for ids, labels in batches:
        lrs.append(opt.get_lr())
        losses.append(step(ids, labels).item())
        sched.step()
    return losses, lrs


def _accumulators(model, opt):
    return {f"{n}.{a}": v.clone()
            for n, p in model.named_parameters()
            for a, v in opt._accumulators[id(p)].items()}


def test_tiny_gpt_resume_is_bit_equal(tmp_path):
    batches = [_batch(20 + i) for i in range(4)]
    model, opt, sched = _port_gpt(0)
    want_losses, want_lrs = _run(model, opt, sched, batches)
    want_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    want_accs = _accumulators(model, opt)

    model, opt, sched = _port_gpt(0)
    losses, lrs = _run(model, opt, sched, batches[:2])
    paddle.save(model.state_dict(), str(tmp_path / "m.pdparams"))
    paddle.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    del model, opt, sched
    model, opt, sched = _port_gpt(1)   # a load that did nothing shows
    missing, unexpected = model.set_state_dict(
        paddle.load(str(tmp_path / "m.pdparams")))
    assert missing == [] and unexpected == []
    opt.set_state_dict(paddle.load(str(tmp_path / "m.pdopt")))
    assert opt._step_count == 2 and sched.last_epoch == 2
    more, more_lrs = _run(model, opt, sched, batches[2:])
    assert losses + more == want_losses
    assert lrs + more_lrs == want_lrs
    for n, p in model.named_parameters():
        assert torch.equal(p, want_params[n]), n
    accs = _accumulators(model, opt)
    assert accs.keys() == want_accs.keys()
    for k, v in accs.items():
        assert v.dtype == want_accs[k].dtype and torch.equal(v,
                                                             want_accs[k]), k


def test_cross_package_resume_matches_the_reference(tmp_path):
    jm, _ = tiny_models()
    jm.train()
    jsched = jpaddle.optimizer.lr.CosineAnnealingDecay(1e-3, 8)
    jopt = jpaddle.optimizer.AdamW(learning_rate=jsched,
                                   parameters=jm.parameters())
    jstep = JaxTrainStep(lambda i, lb: jm(i, labels=lb)[1], jm, jopt,
                         donate=False)
    batches = [_batch(30 + i) for i in range(4)]

    def jrun(pair):
        out = float(np.asarray(jstep(jpaddle.to_tensor(pair[0].numpy()),
                                     jpaddle.to_tensor(pair[1].numpy())
                                     )._value))
        jsched.step()
        return out

    for b in batches[:2]:
        jrun(b)
    jpaddle.save(jm.state_dict(), str(tmp_path / "r.pdparams"))
    jpaddle.save(jopt.state_dict(), str(tmp_path / "r.pdopt"))
    jstate = jopt.state_dict()
    want = [jrun(b) for b in batches[2:]]

    model, opt, sched = _port_gpt(1)
    model.train()
    model.set_state_dict(paddle.load(str(tmp_path / "r.pdparams")))
    opt.set_state_dict(paddle.load(str(tmp_path / "r.pdopt")))
    # the loaded state is the reference's, exactly
    assert sched.last_epoch == jsched.last_epoch - 2 == 2
    for i, p in enumerate(model.parameters()):
        for a in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            np.testing.assert_array_equal(
                opt._accumulators[id(p)][a].numpy(),
                np.asarray(jstate[f"param_{i}.{a}"]._value))
    got, _ = _run(model, opt, sched, batches[2:])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jparams = dict(jm.named_parameters())
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[n]._value),
                                   atol=3e-3, rtol=0, err_msg=n)


def _lenet_model(seed):
    net = models.LeNet(device="cpu", seed=seed)
    opt = popt.Adam(learning_rate=1e-3, parameters=net.parameters())
    return Model(net).prepare(opt, pnn.CrossEntropyLoss())


def _lenet_data():
    rng = np.random.default_rng(4)
    return paddle.io.TensorDataset([
        rng.uniform(0, 1, (16, 1, 28, 28)).astype(np.float32),
        rng.integers(0, 10, (16,)).astype(np.int64)])


def test_model_save_load_and_model_checkpoint(tmp_path):
    data = _lenet_data()
    model = _lenet_model(0)
    d = tmp_path / "ckpt"
    model.fit(data, batch_size=8, epochs=3, verbose=0, shuffle=False,
              callbacks=[ModelCheckpoint(save_freq=2, save_dir=str(d))])
    assert sorted(os.listdir(d)) == ["0.pdopt", "0.pdparams", "2.pdopt",
                                     "2.pdparams", "final.pdopt",
                                     "final.pdparams"]
    # fit's save_dir adds the callback itself
    other = _lenet_model(0)
    other.fit(data, batch_size=8, epochs=1, verbose=0,
              save_dir=str(tmp_path / "auto"))
    assert sorted(os.listdir(tmp_path / "auto")) == [
        "0.pdopt", "0.pdparams", "final.pdopt", "final.pdparams"]
    fresh = _lenet_model(1)
    fresh.load(str(d / "final"))
    for (n, p), q in zip(model.network.named_parameters(),
                         fresh.network.parameters()):
        assert torch.equal(p, q), n
    assert fresh._optimizer._step_count == model._optimizer._step_count == 6
    for p, q in zip(model.network.parameters(), fresh.network.parameters()):
        for a, v in model._optimizer._accumulators[id(p)].items():
            assert torch.equal(v, fresh._optimizer._accumulators[id(q)][a])
    # reset_optimizer leaves the optimizer as it was
    reset = _lenet_model(1)
    reset.load(str(d / "final"), reset_optimizer=True)
    assert reset._optimizer._step_count == 0
    assert not reset._optimizer._accumulators
    # the inference export: jit.save at the Model's inputs, which it needs
    with pytest.raises(ValueError, match="jit.save needs input_spec"):
        model.save(str(tmp_path / "infer"), training=False)
    spec = [paddle.static.InputSpec([2, 1, 28, 28], "float32")]
    exported = Model(model.network, inputs=spec)
    exported.save(str(tmp_path / "infer"), training=False)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (2, 1, 28, 28)).astype(np.float32))
    loaded = paddle.jit.load(str(tmp_path / "infer"), device="cpu")
    model.network.eval()
    with torch.no_grad():
        assert torch.equal(loaded(x), model.network(x))


def test_model_load_skip_mismatch(tmp_path):
    model = _lenet_model(0)
    model.save(str(tmp_path / "m"))
    state = paddle.load(str(tmp_path / "m.pdparams"))
    state["fc.2.bias"] = paddle.to_tensor(np.zeros(7, np.float32))
    paddle.save(state, str(tmp_path / "m.pdparams"))
    fresh = _lenet_model(1)
    with pytest.raises(ValueError, match="shape mismatch"):
        fresh.load(str(tmp_path / "m"))
    fresh = _lenet_model(1)
    before = fresh.network.state_dict()["fc.2.bias"].clone()
    with pytest.warns(UserWarning, match="fc.2.bias"):
        fresh.load(str(tmp_path / "m"), skip_mismatch=True)
    assert torch.equal(fresh.network.state_dict()["fc.2.bias"], before)
    assert torch.equal(fresh.network.state_dict()["fc.0.weight"],
                       model.network.state_dict()["fc.0.weight"])


# -- the six cases of tests/test_dist_checkpoint.py, on the port ------------

def _linear(n_in, n_out, seed):
    return pnn.Linear(n_in, n_out, device="cpu",
                      generator=torch.Generator().manual_seed(seed))


def test_save_load_into_other_destinations(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    state = {"linear": {"weight": paddle.to_tensor(w),
                        "bias": torch.from_numpy(b)}, "step": 7}
    dck.save_state_dict(state, str(tmp_path / "ckpt"))
    # destinations of another dtype and kind keep theirs, written in place
    w2 = paddle.to_tensor(np.zeros((8, 16), np.float64))
    b2 = torch.zeros(16, dtype=torch.bfloat16)
    held = w2._value
    dst = {"linear": {"weight": w2, "bias": b2}, "step": 0}
    dck.load_state_dict(dst, str(tmp_path / "ckpt"))
    assert dst["step"] == 7
    assert w2._value is held and w2._value.dtype == torch.float64
    np.testing.assert_array_equal(w2.numpy(), w.astype(np.float64))
    assert b2.dtype == torch.bfloat16
    assert torch.equal(b2, torch.from_numpy(b).to(torch.bfloat16))


def test_model_roundtrip(tmp_path):
    net = _linear(4, 4, 0)
    ref = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    dck.save_state_dict(net.state_dict(), str(tmp_path / "m"))
    net2 = _linear(4, 4, 1)
    dck.load_state_dict(net2.state_dict(), str(tmp_path / "m"))
    for k, v in net2.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k])


def test_missing_key_raises(tmp_path):
    net = _linear(2, 2, 0)
    dck.save_state_dict(net.state_dict(), str(tmp_path / "x"))
    other = _linear(3, 3, 0)
    with pytest.raises(KeyError):
        dck.load_state_dict({"nope": other.state_dict()["weight"]},
                            str(tmp_path / "x"))


def _corrupt(path, mode):
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    if mode == "flip":
        raw[len(raw) // 2] ^= 0xFF
    else:   # truncate: a torn write
        raw = raw[: len(raw) // 2]
    with open(path, "wb") as f:
        f.write(bytes(raw))


def test_save_records_digests(tmp_path):
    net = _linear(2, 2, 0)
    dck.save_state_dict(net.state_dict(), str(tmp_path / "c"))
    shard = tmp_path / "c" / "shard_0.pkl"
    sidecar = tmp_path / "c" / "shard_0.pkl.sha256"
    digest = hashlib.sha256(shard.read_bytes()).hexdigest()
    assert sidecar.read_text().strip() == digest
    meta = json.loads((tmp_path / "c" / "metadata.json").read_text())
    assert meta["shard_digests"] == {"shard_0.pkl": digest}
    assert meta["tensors"]["weight"] == {"shape": [2, 2],
                                         "dtype": "float32"}
    assert not [f for f in os.listdir(tmp_path / "c") if f.endswith(".tmp")]


def test_load_detects_bitflip_and_truncation(tmp_path):
    net = _linear(4, 4, 0)
    for mode in ("flip", "truncate"):
        d = tmp_path / mode
        dck.save_state_dict(net.state_dict(), str(d))
        _corrupt(str(d / "shard_0.pkl"), mode)
        with pytest.raises(ValueError, match="corrupt"):
            dck.load_state_dict(net.state_dict(), str(d))


def test_latest_checkpoint_skips_corrupt_falls_back(tmp_path, capsys):
    net = _linear(2, 2, 0)
    for step in (0, 1):
        p = tmp_path / f"step_{step}"
        dck.save_state_dict(net.state_dict(), str(p))
        elastic.mark_complete(str(p))
    assert elastic.latest_checkpoint(str(tmp_path)).endswith("step_1")
    _corrupt(str(tmp_path / "step_1" / "shard_0.pkl"), "flip")
    ok, reason = elastic.verify_checkpoint(str(tmp_path / "step_1"))
    assert not ok and "sha256" in reason
    # the newest complete one is corrupt: the previous one, with a reason
    assert elastic.latest_checkpoint(str(tmp_path)).endswith("step_0")
    assert "skipping corrupt checkpoint" in capsys.readouterr().err
    _corrupt(str(tmp_path / "step_0" / "shard_0.pkl"), "truncate")
    assert elastic.latest_checkpoint(str(tmp_path)) is None


# -- the two async cases of tests/test_dcn_async_ckpt.py, on the port -------

def test_async_save_then_load(tmp_path):
    net = _linear(8, 4, 1)
    sd = net.state_dict()
    handle = dck.save_state_dict(sd, str(tmp_path / "ckpt"),
                                 async_save=True)
    assert handle.wait(timeout=60)
    assert handle.done()
    net2 = _linear(8, 4, 2)
    sd2 = net2.state_dict()
    dck.load_state_dict(sd2, str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(net2.weight.detach().numpy(),
                                  net.weight.detach().numpy())


def test_async_value_snapshot_precedes_mutation(tmp_path):
    # the host copy happens when save_state_dict is called: writing the
    # tensor in place right after must not reach the checkpoint
    w = paddle.to_tensor(np.ones((4, 4), np.float32))
    handle = dck.save_state_dict({"w": w}, str(tmp_path / "c2"),
                                 async_save=True)
    w._value.zero_()   # the next train step, in place
    handle.wait(timeout=60)
    target = {"w": paddle.to_tensor(np.zeros((4, 4), np.float32))}
    dck.load_state_dict(target, str(tmp_path / "c2"))
    np.testing.assert_array_equal(target["w"].numpy(), np.ones((4, 4)))


def test_reference_checkpoint_sharded_over_8_devices_loads_whole(tmp_path):
    from paddle_tpu.distributed.sharding_api import build_mesh
    mesh = build_mesh(dp=4, mp=2)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    h = rng.standard_normal((16, 8)).astype(np.float32)
    wj = jax.device_put(jnp.asarray(w), NamedSharding(mesh, P("dp", "mp")))
    hj = jax.device_put(jnp.asarray(h).astype(jnp.bfloat16),
                        NamedSharding(mesh, P("mp", None)))
    jdck.save_state_dict({"w": jpaddle.Tensor(wj), "h": jpaddle.Tensor(hj),
                          "step": 3}, str(tmp_path / "ref"))
    dst = {"w": torch.zeros(8, 16), "h": torch.zeros(16, 8,
                                                     dtype=torch.bfloat16),
           "step": 0}
    dck.load_state_dict(dst, str(tmp_path / "ref"))
    assert dst["step"] == 3
    np.testing.assert_array_equal(dst["w"].numpy(), w)
    want_h = h.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(dst["h"].float().numpy(), want_h)
    # and the reference reads the port's checkpoint back, whole
    dck.save_state_dict({"w": dst["w"], "step": 3}, str(tmp_path / "port"))
    back = {"w": jpaddle.Tensor(jnp.zeros((8, 16), jnp.float32)), "step": 0}
    jdck.load_state_dict(back, str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back["w"]._value), w)


def test_optimizer_state_through_distributed_checkpoint(tmp_path):
    batches = [_batch(40 + i) for i in range(3)]
    model, opt, sched = _port_gpt(0)
    _run(model, opt, sched, batches[:2])
    dck.save_state_dict({"model": model.state_dict(),
                         "opt": opt.state_dict()}, str(tmp_path / "s"))
    want, _ = _run(model, opt, sched, batches[2:])
    model2, opt2, sched2 = _port_gpt(1)
    for p in model2.parameters():   # the accumulators the skeleton lists
        opt2._get_accumulators(p)
    skeleton = {"model": model2.state_dict(), "opt": opt2.state_dict()}
    dck.load_state_dict(skeleton, str(tmp_path / "s"))
    opt2.set_state_dict(skeleton["opt"])
    assert opt2._step_count == 2 and sched2.last_epoch == 2
    got, _ = _run(model2, opt2, sched2, batches[2:])
    assert got == want


# -- the elastic lifecycle, against the reference's functions ---------------

def _tree(root, steps_done, steps_open):
    for s in steps_done + steps_open:
        os.makedirs(root / f"step_{s}")
        if s in steps_done:
            (root / f"step_{s}" / ".done").write_text("1")
    (root / "step_x").mkdir()


def test_gc_and_mark_complete_as_the_reference(tmp_path, monkeypatch):
    results = []
    for pkg, name in ((elastic, "port"), (jelastic, "ref")):
        root = tmp_path / name
        _tree(root, [1, 3, 5, 7], [2, 9])
        deleted = pkg.gc_checkpoints(str(root), keep_last_k=2)
        results.append(sorted(os.path.basename(p) for p in deleted))
        monkeypatch.setenv(pkg.KEEP_CKPTS_ENV, "1")
        os.makedirs(root / "step_11")
        pkg.mark_complete(str(root / "step_11"))
        results.append(sorted(os.listdir(root)))
        results.append(os.path.basename(pkg.latest_checkpoint(str(root))))
        results.append(pkg.checkpoint_path(4, str(root))[len(str(root)):])
    assert results[:4] == results[4:]
    assert results[0] == ["step_1", "step_2", "step_3"]
    assert elastic.restart_count() == 0
    monkeypatch.setenv(elastic.RESTART_ENV, "3")
    assert elastic.restart_count() == jelastic.restart_count() == 3


_PREEMPT = r'''
import os, signal, sys, time
from paddle_tpu_torch.distributed import elastic
path = sys.argv[1]
elastic.enable_preemption_checkpoint(
    lambda: open(path, "w").write("saved"), exit_code=7)
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(30)
'''


def test_preemption_hook_saves_once_and_exits():
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "final")
        proc = subprocess.run([sys.executable, "-c", _PREEMPT, path],
                              capture_output=True, text=True, timeout=60,
                              env={**os.environ, "PYTHONPATH": str(ROOT)})
        assert proc.returncode == 7, proc.stderr
        with open(path) as f:
            assert f.read() == "saved"
