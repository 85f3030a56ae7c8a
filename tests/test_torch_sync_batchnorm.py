"""``SyncBatchNorm`` of the port (``nn/layer/norm.py``,
``F.sync_batch_norm``).

- Two ranks over gloo on the CPU (the port's launcher), each holding half
  of a batch: the outputs, the running statistics, dx and the sums over
  ranks of dγ and dβ, against the reference's ``BatchNorm2D`` on the
  concatenated batch in one process, in fp32, at 2e-5 of each tensor's
  largest entry (one fp32 reduction order against another over 200
  values a channel), NCHW and NHWC.
- In a group of one rank it is the port's ``BatchNorm2D`` bit for bit,
  in training and in eval.
- ``convert_sync_batchnorm`` swaps every batch norm and keeps its
  parameter and buffer objects.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu_torch import nn as pnn

from _torch_dist_helpers import assert_ranks_ok, launch

_SHAPE = (8, 4, 5, 5)    # the concatenated batch; each rank takes 4 rows


def _inputs():
    rng = np.random.default_rng(12)
    x = (rng.standard_normal(_SHAPE) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal(_SHAPE).astype(np.float32)
    w = rng.uniform(0.5, 1.5, _SHAPE[1]).astype(np.float32)
    b = rng.standard_normal(_SHAPE[1]).astype(np.float32)
    return x, dy, w, b


_WORKER = """
import numpy as np
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn
dist.init_parallel_env(device="cpu")
r = dist.get_rank()
x, dy, w, b = INPUTS
out = {}
for fmt in ("NCHW", "NHWC"):
    bn = nn.SyncBatchNorm(4, data_format=fmt, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xr = torch.from_numpy(x[4 * r:4 * r + 4].copy())
    dyr = torch.from_numpy(dy[4 * r:4 * r + 4].copy())
    if fmt == "NHWC":
        xr, dyr = xr.permute(0, 2, 3, 1).contiguous(), \\
            dyr.permute(0, 2, 3, 1).contiguous()
    xr.requires_grad_(True)
    y = bn(xr)
    (y * dyr).sum().backward()
    if fmt == "NHWC":
        y, dx = y.permute(0, 3, 1, 2), xr.grad.permute(0, 3, 1, 2)
    else:
        dx = xr.grad
    for k, v in (("y", y), ("dx", dx), ("dw", bn.weight.grad),
                 ("db", bn.bias.grad), ("mean", bn._mean),
                 ("var", bn._variance)):
        out[fmt + "/" + k] = v.detach().numpy()
np.savez(f"{OUT}/rank{r}.npz", **out)
print(f"rank{r} ok", flush=True)
"""


def _reference(x, dy, w, b):
    bn = jpaddle.nn.BatchNorm2D(4)
    bn.weight._value = jpaddle.to_tensor(w)._value
    bn.bias._value = jpaddle.to_tensor(b)._value
    bn.train()
    xt = jpaddle.to_tensor(x, stop_gradient=False)
    y = bn(xt)
    (y * jpaddle.to_tensor(dy)).sum().backward()
    return {"y": y.numpy(), "dx": xt.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "mean": bn._mean.numpy(), "var": bn._variance.numpy()}


def _close(got, want, what):
    bound = 2e-5 * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= bound, (what, err, bound)


def test_two_ranks_match_the_reference_on_the_concatenated_batch(tmp_path):
    x, dy, w, b = _inputs()
    inputs = "(" + ", ".join(f"np.array({v.tolist()!r}, np.float32)"
                             for v in (x, dy, w, b)) + ")"
    proc, logs = launch(tmp_path, f"OUT = {str(tmp_path)!r}\n"
                        + _WORKER.replace("INPUTS", inputs))
    assert_ranks_ok(proc, logs)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    want = _reference(x, dy, w, b)
    for fmt in ("NCHW", "NHWC"):
        def get(k):
            return [rk[f"{fmt}/{k}"] for rk in ranks]
        _close(np.concatenate(get("y")), want["y"], (fmt, "y"))
        _close(np.concatenate(get("dx")), want["dx"], (fmt, "dx"))
        _close(sum(get("dw")), want["dw"], (fmt, "dw"))
        _close(sum(get("db")), want["db"], (fmt, "db"))
        for k in ("mean", "var"):
            a, c = get(k)
            np.testing.assert_array_equal(a, c)
            _close(a, want[k], (fmt, k))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_group_of_one_is_batch_norm_bit_for_bit(fmt):
    x, dy, w, b = _inputs()
    if fmt == "NHWC":
        x, dy = x.transpose(0, 2, 3, 1).copy(), dy.transpose(0, 2, 3, 1).copy()
    outs = []
    for cls in (pnn.BatchNorm2D, pnn.SyncBatchNorm):
        bn = cls(4, data_format=fmt, device="cpu")
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(w))
            bn.bias.copy_(torch.from_numpy(b))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = bn(xt)
        (y * torch.from_numpy(dy)).sum().backward()
        bn.eval()
        outs.append((y, xt.grad, bn.weight.grad, bn.bias.grad, bn._mean,
                     bn._variance, bn(xt)))
    for a, c in zip(*outs):
        assert torch.equal(a, c)


def test_convert_keeps_the_parameters_and_statistics():
    from paddle_tpu_torch.vision.models import resnet18
    net = resnet18(num_classes=10, device="cpu")
    params = {id(p) for p in net.parameters()}
    bufs = {id(b) for b in net.buffers()}
    n_bn = sum(isinstance(m, pnn.BatchNorm2D) for m in net.modules())
    out = pnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert out is net
    assert sum(isinstance(m, pnn.SyncBatchNorm) for m in net.modules()) \
        == n_bn > 10
    assert not any(type(m) is pnn.BatchNorm2D for m in net.modules())
    assert {id(p) for p in net.parameters()} == params
    assert {id(b) for b in net.buffers()} == bufs
    bn = pnn.BatchNorm2D(3, momentum=0.8, epsilon=1e-3, device="cpu")
    bn.eval()
    sync = pnn.SyncBatchNorm.convert_sync_batchnorm(bn)
    assert isinstance(sync, pnn.SyncBatchNorm) and not sync.training
    assert (sync._momentum, sync._epsilon) == (0.8, 1e-3)
    assert sync.weight is bn.weight and sync._variance is bn._variance
