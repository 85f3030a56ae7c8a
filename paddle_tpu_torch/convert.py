"""Carry a JAX ``GPTForPretraining``'s weights into the port.

Two input forms, both plain numpy (the port never imports the JAX
package; the caller converts):

- the JAX model's ``state_dict()`` as ``{name: np.asarray(p._value)}``,
  whose names (``gpt.wte.weight``, ``gpt.blocks.0.attn.qkv_proj.weight``,
  ``lm_head.weight`` ...) are the port's own;
- the serving engine's ``extract_gpt_params`` tree (``wte``, ``wpe``,
  ``lnf_w``, ``blocks: [{ln1_w, qkv_w, ...}]``, ``head_w``) with its
  leaves converted to numpy.

Both packages keep Paddle's [in, out] Linear layout, so every array
carries across as it is: no transpose.
"""
from __future__ import annotations

import numpy as np
import torch

_BLOCK_KEYS = {
    "ln1_w": "ln1.weight", "ln1_b": "ln1.bias",
    "qkv_w": "attn.qkv_proj.weight", "qkv_b": "attn.qkv_proj.bias",
    "out_w": "attn.out_proj.weight", "out_b": "attn.out_proj.bias",
    "ln2_w": "ln2.weight", "ln2_b": "ln2.bias",
    "fi_w": "mlp.fc_in.weight", "fi_b": "mlp.fc_in.bias",
    "fo_w": "mlp.fc_out.weight", "fo_b": "mlp.fc_out.bias",
}
_TOP_KEYS = {"wte": "gpt.wte.weight", "wpe": "gpt.wpe.weight",
             "lnf_w": "gpt.ln_f.weight", "lnf_b": "gpt.ln_f.bias",
             "head_w": "lm_head.weight"}


def gpt_state_from_jax(np_state):
    """{port parameter name: np.ndarray} from either input form."""
    if "blocks" not in np_state:
        return {str(k): np.asarray(v) for k, v in np_state.items()}
    out = {}
    for key, value in np_state.items():
        if key == "blocks":
            for i, blk in enumerate(value):
                for bk, v in blk.items():
                    out[f"gpt.blocks.{i}.{_BLOCK_KEYS[bk]}"] = np.asarray(v)
        else:
            out[_TOP_KEYS[key]] = np.asarray(value)
    return out


@torch.no_grad()
def load_jax_gpt(port_model, np_state):
    """Load the JAX weights into the port's ``GPTForPretraining`` in
    place, on the model's device and in its dtype. The names and shapes
    must match exactly (a tied model has no ``lm_head.weight``). Returns
    the model."""
    state = gpt_state_from_jax(np_state)
    params = dict(port_model.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"weights do not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in params.items():
        arr = state[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != model "
                             f"{tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
    return port_model
