"""``chip_smoke.py``'s elastic path on the CPU, at the tiny GPT of
``tests/_torch_helpers.py``'s ``tiny_models`` (hidden 128, 2 heads of 64, 2
layers, vocab 128, 256 tokens; ``device="cpu"``): two agents through the
port's ``launch --elastic`` (agent 0 hosting the store), trainers that are
gloo ranks each on its rows of a step's global batch, a
``distributed.checkpoint`` every 2 steps.

- Killed and resumed: node 0's trainer exits non-zero after step 5 (the
  path's planted fault); its agent restarts generation 1 at world 2 from
  the step-4 checkpoint, and step 5 there equals the uninterrupted
  generation 0's step 5 bit for bit (each rank's loss, the global
  gradient norm).
- Scaled in from 2 to 1: node 1's agent and trainer are SIGKILLed after
  step 6's checkpoint; node 0 detects it, bumps the generation and goes on
  at world 1, and its step 7 equals one process's ``CompiledTrainStep``
  from the step-6 checkpoint on the whole batch bit for bit (loss, norm,
  every parameter's bytes).
- Node 0's restart count is 1 after both events and its agent exits 0.

``phase_elastic`` raises on any of these; the test reads its JSON line
too."""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=256, dropout=0.0, tie_word_embeddings=True)

_TRAINER = """
import sys
sys.path.insert(0, %(root)r)
import torch
import chip_smoke as cs
from paddle_tpu_torch.text import gpt
gpt.gpt_small = lambda **kw: gpt.GPTConfig(**%(tiny)r)
sys.exit(cs.elastic_rank(torch, sys.argv[2], device="cpu"))
""" % {"root": ROOT, "tiny": TINY}


def test_elastic_tiny_gpt_restart_and_scale_in(tmp_path, monkeypatch,
                                               capsys):
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.text import gpt
    script = tmp_path / "trainer.py"
    script.write_text(_TRAINER)
    monkeypatch.setattr(gpt, "gpt_small", lambda **kw: gpt.GPTConfig(**TINY))
    # a last call longer than two agents' start-up can drift apart on a
    # loaded test machine, so generation 0 forms at world 2
    monkeypatch.setitem(cs.EL_ENV, "PADDLE_ELASTIC_LAST_CALL", "5.0")
    # one thread in the trainers and here: a CPU GEMM's reduction order
    # follows the thread count, and the gate is bit-equality
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cs.phase_elastic(torch, ck, {}, script=str(script), device="cpu")
    finally:
        torch.set_num_threads(threads)
    line = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith('{"phase": "elastic"')][-1]
    assert [(g["world"], g["first_step"]) for g in line["generations"]] == \
        [(2, 1), (2, 5), (1, 7)]
    before, after = line["step_5_before_after"]
    assert before == after and len(before) == 2
    gate = line["world1_gate"]
    assert gate["trainer"] == gate["one_process"] and \
        gate["params_bit_equal"]
    assert [g["restarts_by_node"] for g in line["generations"]][1:] == \
        [{"0": 1, "1": 0}, {"0": 1}]
    assert line["agent0_rc"] == 0 and line["trainer_steps"] == 16
