"""``paddle.save``/``paddle.load`` of the port (``paddle_tpu_torch/framework/
io.py``) against the JAX package's.

- The reference's ``test_save_load`` case (``tests/test_tensor_basic.py``)
  runs on both packages with the same result.
- Tensors round trip bit for bit with their dtype (fp32, fp16, bf16,
  int64, bool) and ``stop_gradient``, whether saved as paddle ``Tensor``s,
  torch tensors or ``nn.Parameter``s; ``return_numpy`` gives NumPy arrays
  (bf16 widened to float32, exactly); a loaded tensor lands on the current
  place.
- Files the JAX package wrote (a tiny GPT's ``state_dict``, an AdamW
  state with its ``LR_Scheduler``, bf16 arrays inside and outside tensors)
  read equal, exactly, in a subprocess that then finds neither ``jax`` nor
  ``paddle_tpu`` in ``sys.modules``; a file naming any other reference
  global is refused with the global's name.
- The generator states, the scheduler's state and ``GradScaler``'s state
  round trip unchanged.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from _torch_ops_sweep import on_cpu  # noqa: F401  (autouse: the CPU place)

ROOT = Path(__file__).resolve().parents[1]


def test_reference_save_load_case_on_both_packages(tmp_path):
    results = []
    for pkg in (jpaddle, paddle):
        obj = {"w": pkg.ones([2, 2]), "step": 3,
               "nested": [pkg.zeros([1])]}
        p = str(tmp_path / f"{pkg.__name__}.pdparams")
        pkg.save(obj, p)
        loaded = pkg.load(p)
        assert loaded["step"] == 3
        np.testing.assert_array_equal(loaded["w"].numpy(), np.ones((2, 2)))
        results.append((loaded["step"], loaded["w"].numpy().tolist(),
                        loaded["nested"][0].numpy().tolist()))
    assert results[0] == results[1]


DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64,
          torch.bool]


def _values(dtype):
    rng = np.random.default_rng(0)
    if dtype == torch.bool:
        return torch.from_numpy(rng.random((3, 5)) < 0.5)
    if dtype == torch.int64:
        return torch.from_numpy(rng.integers(-2**40, 2**40, (3, 5)))
    return torch.from_numpy(rng.standard_normal((3, 5)) * 1e3).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_tensors_round_trip_with_dtype_and_stop_gradient(dtype, tmp_path):
    v = _values(dtype)
    grad_ok = dtype.is_floating_point
    tensors = {"paddle_sg": paddle.Tensor(v.clone()),
               "paddle_trainable": paddle.to_tensor(
                   v.clone(), stop_gradient=not grad_ok),
               "torch": v.clone()}
    if grad_ok:
        tensors["param"] = torch.nn.Parameter(v.clone())
    path = str(tmp_path / "t.pdparams")
    paddle.save(tensors, path)
    loaded = paddle.load(path)
    for name, t in tensors.items():
        got = loaded[name]
        assert isinstance(got, paddle.Tensor), name
        assert got._value.dtype == dtype, name
        assert torch.equal(got._value, v), name   # bit for bit
        want_sg = t.stop_gradient if isinstance(t, paddle.Tensor) \
            else not t.requires_grad
        assert got.stop_gradient == want_sg, name
        assert got.place == paddle.CPUPlace()
    arrays = paddle.load(path, return_numpy=True)
    for name in tensors:
        a = arrays[name]
        assert isinstance(a, np.ndarray)
        want = v.float().numpy() if dtype == torch.bfloat16 else v.numpy()
        assert a.dtype == want.dtype
        np.testing.assert_array_equal(a, want)


def test_python_values_and_arrays_stay_as_they_are(tmp_path):
    obj = {"ints": (1, 2), "s": "x", "f": 0.1, "none": None,
           "arr": np.arange(4, dtype=np.int32), "l": [[1.5]]}
    path = str(tmp_path / "d" / "obj.pkl")
    paddle.save(obj, path)   # makes the directory
    got = paddle.load(path)
    assert got["ints"] == (1, 2) and got["s"] == "x" and got["f"] == 0.1
    assert got["none"] is None and got["l"] == [[1.5]]
    assert got["arr"].dtype == np.int32 and got["arr"].tolist() == \
        [0, 1, 2, 3]


_READ_REFERENCE_FILES = r'''
import json, sys
import numpy as np
import torch
import paddle_tpu_torch as paddle
paddle.set_device("cpu")
d = sys.argv[1]
out = {}
for name in ("gpt.pdparams", "adamw.pdopt", "bf16.pkl"):
    obj = paddle.load(d + "/" + name)
    for k, v in (obj.items()):
        if k == "LR_Scheduler":
            out[name + ":" + k] = v
            continue
        t = v._value if isinstance(v, paddle.Tensor) else v
        if torch.is_tensor(t):
            kind = "Tensor" if isinstance(v, paddle.Tensor) else "torch"
            out[name + ":" + k] = [kind, str(t.dtype),
                                   t.detach().float().numpy().tolist(),
                                   None if kind == "torch" else
                                   v.stop_gradient]
        else:
            out[name + ":" + k] = v
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(json.dumps({"values": out, "leaked": leaked}))
'''


def _reference_files(d):
    """A tiny GPT's state_dict, an AdamW state after one step under a
    cosine schedule, and bf16 arrays, each written by the JAX package.
    Returns what each should read as."""
    from paddle_tpu.text.gpt import GPTConfig, GPTForPretraining
    jpaddle.seed(0)
    m = GPTForPretraining(GPTConfig(vocab_size=64, hidden_size=32,
                                    num_layers=1, num_heads=2,
                                    max_seq_len=16))
    sched = jpaddle.optimizer.lr.CosineAnnealingDecay(1e-3, 10)
    opt = jpaddle.optimizer.AdamW(learning_rate=sched,
                                  parameters=m.parameters())
    ids = jpaddle.to_tensor(np.random.default_rng(0).integers(0, 64,
                                                              (2, 16)))
    m(ids, labels=ids)[1].backward()
    opt.step()
    sched.step()
    jpaddle.save(m.state_dict(), f"{d}/gpt.pdparams")
    jpaddle.save(opt.state_dict(), f"{d}/adamw.pdopt")
    bf = np.asarray([1.5, -2.25, 3e38, 1e-30], np.float32)
    jpaddle.save({"array": bf.astype(ml_dtypes.bfloat16),
                  "tensor": jpaddle.to_tensor(bf).astype("bfloat16"),
                  "step": 4}, f"{d}/bf16.pkl")
    want = {}
    for k, v in m.state_dict().items():
        want["gpt.pdparams:" + k] = ["Tensor", "torch.float32",
                                     np.asarray(v._value).tolist(),
                                     v.stop_gradient]
    for k, v in opt.state_dict().items():
        if k in ("LR_Scheduler", "@step"):   # Python values, as they are
            want["adamw.pdopt:" + k] = v
        else:
            want["adamw.pdopt:" + k] = ["Tensor", "torch.float32",
                                        np.asarray(v._value,
                                                   np.float32).tolist(),
                                        v.stop_gradient]
    widened = bf.astype(ml_dtypes.bfloat16).astype(np.float32).tolist()
    want["bf16.pkl:array"] = ["torch", "torch.bfloat16", widened, None]
    want["bf16.pkl:tensor"] = ["Tensor", "torch.bfloat16", widened, True]
    want["bf16.pkl:step"] = 4
    return want


def test_files_written_by_the_reference_read_equal_without_it(tmp_path):
    want = _reference_files(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", _READ_REFERENCE_FILES, str(tmp_path)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    assert set(got["values"]) == set(want)
    for k in want:   # exactly: fp32 and bf16 values carry over as bits
        assert got["values"][k] == json.loads(json.dumps(want[k])), k


def test_a_reference_global_other_than_the_payload_is_refused(tmp_path):
    path = tmp_path / "place.pkl"
    with open(path, "wb") as f:
        pickle.dump({"place": jpaddle.CPUPlace()}, f, protocol=4)
    with pytest.raises(pickle.UnpicklingError,
                       match="paddle_tpu.framework.place.CPUPlace"):
        paddle.load(str(path))


def test_rng_scheduler_and_scaler_state_round_trip(tmp_path):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import lr
    paddle.seed(11)
    cpu_state = paddle.get_rng_state()
    want = torch.rand(4, generator=paddle.framework.generator(
        torch.device("cpu")))
    sched = lr.CosineAnnealingDecay(0.1, 20)
    for _ in range(3):
        sched.step()
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    scaler._good_steps = 5
    path = str(tmp_path / "state.pdparams")
    paddle.save({"rng": cpu_state, "sched": sched.state_dict(),
                 "scaler": scaler.state_dict()}, path)
    got = paddle.load(path)
    paddle.seed(99)
    paddle.set_rng_state(got["rng"])
    again = torch.rand(4, generator=paddle.framework.generator(
        torch.device("cpu")))
    assert torch.equal(want, again)
    fresh = lr.CosineAnnealingDecay(0.1, 20)
    fresh.set_state_dict(got["sched"])
    assert fresh.state_dict() == sched.state_dict()
    assert fresh() == sched()
    other = amp.GradScaler()
    other.load_state_dict(got["scaler"])
    assert got["scaler"] == scaler.state_dict()
    assert other._scale == 1024.0 and other._good_steps == 5
