"""Carry a JAX model's weights into the port.

``load_jax_state`` takes any JAX model's ``state_dict()`` as
``{name: numpy array}`` (ERNIE, BERT, ResNet, the encoder layers...): the
port's parameter and buffer names are the reference's, so names carry
across as they are (``ernie.encoder.layers.0.self_attn.q_proj.weight``,
``cls.decoder_bias``, ``layer1.0.downsample.1._mean``; a tied weight
appears once, under the layer that holds it).

``load_jax_gpt`` takes a JAX ``GPTForPretraining``'s weights in two
forms, both plain numpy (the port never imports the JAX package; the
caller converts):

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
def load_jax_state(port_model, np_state):
    """Load ``{name: np.ndarray}`` into ``port_model``'s parameters and
    buffers (a batch norm's running statistics) in place, on the model's
    device and in each tensor's dtype. The names and shapes must match
    the model's exactly: a missing or unexpected name raises KeyError, a
    wrong shape ValueError. Returns the model."""
    params = {**dict(port_model.named_parameters()),
              **dict(port_model.named_buffers())}
    missing = sorted(set(params) - set(np_state))
    unexpected = sorted(set(np_state) - set(params))
    if missing or unexpected:
        raise KeyError(f"weights do not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in params.items():
        arr = np.asarray(np_state[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != model "
                             f"{tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
    return port_model


def load_jax_gpt(port_model, np_state):
    """Load the JAX weights, in either form, into the port's
    ``GPTForPretraining`` through ``load_jax_state`` (a tied model has no
    ``lm_head.weight``). Returns the model."""
    return load_jax_state(port_model, gpt_state_from_jax(np_state))
