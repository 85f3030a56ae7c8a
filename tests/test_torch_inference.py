"""paddle.inference of the port (``paddle_tpu_torch/inference/``): the
four predictor cases of ``tests/test_inference.py`` (handles, positional
run, config knobs, unknown input) on the port's ``jit.save`` artifact,
against the reference predictor's outputs on the same MLP weights,
within 1e-5 (atol and rtol: two 6- and 8-wide fp32 products). The
port's ``Config`` means the card unless ``disable_gpu()`` is called, so
each case here calls it; without a card the default raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from _torch_ops_sweep import on_cpu  # noqa: F401  (the port's place: CPU)
from paddle_tpu import inference as jinf
from paddle_tpu_torch import inference as tinf

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(port path, reference path, input, reference predictor output)."""
    jpaddle.seed(5)
    jnet = jpaddle.nn.Sequential(jpaddle.nn.Linear(6, 8), jpaddle.nn.ReLU(),
                                 jpaddle.nn.Linear(8, 3))
    jnet.eval()
    tnet = tpaddle.nn.Sequential(tpaddle.nn.Linear(6, 8, device="cpu"),
                                 tpaddle.nn.ReLU(),
                                 tpaddle.nn.Linear(8, 3, device="cpu"))
    with torch.no_grad():
        for p, q in zip(tnet.parameters(), jnet.parameters()):
            p.copy_(torch.from_numpy(np.array(q.numpy())))
    tnet.eval()
    d = tmp_path_factory.mktemp("infer")
    jpath, tpath = str(d / "ref"), str(d / "port")
    jpaddle.jit.save(jnet, jpath, input_spec=[
        jpaddle.static.InputSpec([4, 6], "float32")])
    tpaddle.jit.save(tnet, tpath, input_spec=[
        tpaddle.static.InputSpec([4, 6], "float32")])
    x = np.random.default_rng(5).uniform(-1, 1, (4, 6)).astype("float32")
    ref = jinf.create_predictor(jinf.Config(jpath + ".pdmodel")).run([x])
    return tpath, jpath, x, ref[0]


def _config(*files):
    cfg = tinf.Config(*files)
    cfg.disable_gpu()
    return cfg


def test_handle_api_roundtrip(saved):
    path, _, x, ref = saved
    pred = tinf.create_predictor(_config(path + ".pdmodel",
                                         path + ".pdiparams"))
    names = pred.get_input_names()
    assert names == ["x0"]
    h = pred.get_input_handle(names[0])
    h.copy_from_cpu(x)
    assert h.shape() == [4, 6]
    assert pred.run() is True
    out_names = pred.get_output_names()
    assert out_names == ["out0"]
    out = pred.get_output_handle(out_names[0]).copy_to_cpu()
    np.testing.assert_allclose(out, ref, **TOL)


def test_positional_run(saved):
    path, _, x, ref = saved
    outs = tinf.create_predictor(_config(path + ".pdmodel")).run([x])
    np.testing.assert_allclose(outs[0], ref, **TOL)


def test_config_compat_knobs(saved):
    path, _, x, ref = saved
    cfg = tinf.Config(path + ".pdmodel", path + ".pdiparams")
    assert cfg.use_gpu()   # the card by default
    cfg.enable_memory_optim()
    cfg.switch_ir_optim(True)
    cfg.disable_gpu()
    cfg.set_cpu_math_library_num_threads(4)
    cfg.enable_tensorrt_engine(workspace_size=1 << 20)
    assert not cfg.use_gpu()
    assert "Config(" in cfg.summary()
    pred = tinf.create_predictor(cfg)
    assert pred.get_input_names()
    np.testing.assert_allclose(pred.run([x])[0], ref, **TOL)
    assert not pred.graphs   # no CUDA graph on the CPU


def test_unknown_input_raises(saved):
    path, jpath, _, _ = saved
    for inf, cfg in ((jinf, jinf.Config(jpath + ".pdmodel")),
                     (tinf, _config(path + ".pdmodel"))):
        pred = inf.create_predictor(cfg)
        with pytest.raises(KeyError, match="unknown input"):
            pred.get_input_handle("nope")
        with pytest.raises(RuntimeError, match="inputs not set"):
            pred.run()


def test_default_config_needs_a_card(saved):
    path, _, _, _ = saved
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default config serves on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tinf.create_predictor(tinf.Config(path + ".pdmodel"))
