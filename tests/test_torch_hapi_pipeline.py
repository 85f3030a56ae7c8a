"""``hapi.Model`` over a one-process ``PipelineParallel`` on the port
(``paddle_tpu_torch/hapi/model.py``) against the reference's ``Model`` over
the same pipeline: ``network(*ins)`` is the whole ``PipelineLayer`` through
``PipelineParallel.forward``, compiled into the train step as the reference
compiles it.

The reference's bottleneck pipeline (Linear 8->4, Tanh, Linear 4->8 a
stage, two stages, the reference's single-process ``_FakeHcg``) with the
reference's weights carried across as numpy; ``fit`` for four batches of 4
(SGD and Momentum; AdamW's first steps divide by the root of a second
moment near eps, which turns fp32 rounding into parameter differences
above the tolerance), then ``evaluate`` and ``predict``: every loss, every
parameter after ``fit``, the evaluation's loss and the predictions within
1e-6 of each one's largest entry. Over a ``PipelineParallel`` whose pp
ranks are processes the port's ``Model`` raises naming ROADMAP A7
(``tests/test_torch_topology.py``)."""
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JLayerDesc, PipelineLayer as JPipelineLayer,
    PipelineParallel as JPipelineParallel)
from paddle_tpu.hapi.callbacks import Callback as JCallback

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel)
from paddle_tpu_torch.hapi.callbacks import Callback
from paddle_tpu_torch.hapi.model import Model
from paddle_tpu_torch.io import TensorDataset

TOL = 1e-6


class _FakeHcg:
    """One process standing in for the pp stages."""

    def __init__(self, pp):
        self._pp = pp

    def get_pipe_parallel_world_size(self):
        return self._pp

    def get_stage_id(self):
        return 0

    def get_pipe_parallel_group(self):
        return SimpleNamespace(ranks=list(range(self._pp)))


def _strategy():
    return SimpleNamespace(pipeline_configs={
        "micro_batch_size": 2, "accumulate_steps": 2,
        "schedule_mode": "1F1B"})


def _pipes(pp=2):
    paddle.seed(0)
    jdescs, tdescs = [], []
    for _ in range(pp):
        jdescs += [JLayerDesc(jnn.Linear, 8, 4), JLayerDesc(jnn.Tanh),
                   JLayerDesc(jnn.Linear, 4, 8)]
        tdescs += [LayerDesc(tnn.Linear, 8, 4, device="cpu"),
                   LayerDesc(tnn.Tanh),
                   LayerDesc(tnn.Linear, 4, 8, device="cpu")]
    jm = JPipelineLayer(jdescs, num_stages=pp)
    tm = PipelineLayer(tdescs, num_stages=pp)
    load_jax_state(tm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return (JPipelineParallel(jm, _FakeHcg(pp), _strategy()),
            PipelineParallel(tm, _FakeHcg(pp), _strategy()))


def _mse(out, label):
    """The reference's ``nn.MSELoss()`` (mean reduction) on the port."""
    return ((out - label) * (out - label)).mean()


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
    return Recorder()


def _rel(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _data(n=16, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 8).astype("float32"), rs.randn(n, 8).astype("float32")


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_model_fit_over_pipeline_parallel_matches_reference(opt):
    jp, tp = _pipes()
    if opt == "sgd":
        jopt = paddle.optimizer.SGD(learning_rate=0.05,
                                    parameters=jp.parameters())
        popt = topt.SGD(learning_rate=0.05, parameters=tp.parameters())
    else:
        jopt = paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                         parameters=jp.parameters())
        popt = topt.Momentum(learning_rate=0.05, momentum=0.9,
                             parameters=tp.parameters())
    x, y = _data()
    jrec, prec = _recorder(JCallback), _recorder(Callback)
    jmodel = paddle.Model(jp)
    jmodel.prepare(jopt, paddle.nn.MSELoss())
    jmodel.fit(paddle.io.DataLoader(paddle.io.TensorDataset([x, y]),
                                    batch_size=4, shuffle=False),
               batch_size=4, shuffle=False, verbose=0, callbacks=[jrec])
    pmodel = Model(tp)
    assert pmodel.network is tp
    pmodel.prepare(popt, _mse)
    pmodel.fit(TensorDataset([x, y]), batch_size=4, shuffle=False,
               verbose=0, callbacks=[prec])
    assert len(prec.losses) == len(jrec.losses) == 4
    assert _rel(prec.losses, jrec.losses) <= TOL, (prec.losses,
                                                   jrec.losses)
    jparams = {k: np.asarray(v._value)
               for k, v in jp._layers.state_dict().items()}
    for name, p in tp._layers.state_dict().items():
        assert _rel(p.detach().numpy(), jparams[name]) <= TOL, name
    xe, ye = _data(8, seed=1)
    jev = jmodel.evaluate(paddle.io.DataLoader(
        paddle.io.TensorDataset([xe, ye]), batch_size=4, shuffle=False),
        batch_size=4, verbose=0)
    pev = pmodel.evaluate(TensorDataset([xe, ye]), batch_size=4, verbose=0)
    assert _rel(np.ravel(pev["loss"]), np.ravel(jev["loss"])) <= TOL
    jpred = jmodel.predict(paddle.io.DataLoader(
        paddle.io.TensorDataset([xe]), batch_size=4, shuffle=False),
        batch_size=4, stack_outputs=True, verbose=0)
    ppred = pmodel.predict(TensorDataset([xe]), batch_size=4,
                           stack_outputs=True, verbose=0)
    assert _rel(np.asarray(ppred[0]), np.asarray(jpred[0])) <= TOL
