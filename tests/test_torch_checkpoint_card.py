"""``distributed.checkpoint``'s async save on each device: the values are
taken when ``save_state_dict`` returns (an in-place write right after it
does not reach the files), for a whole fp32 tensor, a bf16 one and a
placed tensor of two pieces (this rank holds global rows 4:8 first, then
rows 0:4), and the shard file is byte for byte a synchronous save's of
the same values. On the card the values are taken by a copy on the card
that the writer thread moves to the host; on the CPU by a host copy.

This file imports only the port; the card's case is marked ``cuda``:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_checkpoint_card.py
"""
import pytest
import torch

from paddle_tpu_torch.distributed import checkpoint as dck
from paddle_tpu_torch.distributed.sharding_api import Placement, place

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
ROWS = ((0, 4), (0, 6)), ((4, 8), (0, 6))


def _state(device):
    """The state on ``device`` and the placed tensor's global value."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 6, generator=g).to(device)
    h = torch.randn(4, 4, generator=g).to(device, torch.bfloat16)
    whole = torch.randn(8, 6, generator=g)
    split = place(torch.cat([whole[4:], whole[:4]]).to(device),
                  Placement((8, 6), [(ROWS[0], ROWS[1]),
                                     (ROWS[1], ROWS[0])], axes=("mp",)))
    return {"w": w, "h": h, "split": split, "step": 3}, whole


@pytest.mark.parametrize("device", DEVICES)
def test_async_save_takes_the_values_when_it_returns(tmp_path, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    state, whole = _state(device)
    want = {k: v.cpu().clone() for k, v in state.items()
            if isinstance(v, torch.Tensor)}
    dck.save_state_dict(state, str(tmp_path / "sync"))
    handle = dck.save_state_dict(state, str(tmp_path / "async"),
                                 async_save=True)
    for k in want:
        state[k].zero_()   # the next step, in place
    assert handle.wait(timeout=60)
    shard = "shard_0.pkl"
    assert (tmp_path / "async" / shard).read_bytes() == \
        (tmp_path / "sync" / shard).read_bytes()
    dst = {"w": torch.zeros(8, 6),
           "h": torch.zeros(4, 4, dtype=torch.bfloat16),
           "split": torch.zeros(8, 6), "step": 0}
    dck.load_state_dict(dst, str(tmp_path / "async"))
    assert torch.equal(dst["w"], want["w"])
    assert torch.equal(dst["h"], want["h"])
    assert torch.equal(dst["split"], whole)
    assert dst["step"] == 3
