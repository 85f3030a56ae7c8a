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

``slice_gpt_state`` cuts such a whole state into one rank's pieces at
(pp, sharding, mp) and ``n_chunks``, by the rules the model's layers
follow. A tensor-parallel GPT (``GPTConfig(tensor_parallel=True)`` or
``sequence_parallel=True``): the packed qkv split per head within each
of q, k and v (its columns and bias), ``fc_in`` by columns,
``out_proj`` and ``fc_out`` by rows (their biases whole), ``wte`` by
vocabulary rows, the norms, ``wpe`` and an untied ``lm_head`` whole. A
``GPTForPretrainingPipe``'s whole state (``wte.weight``,
``blocks.qkv_w`` [L, H, 3, H], ... in natural layer order, as the
reference holds it without a pp axis): the stacked rows chunk-major for
the interleaved schedule, one stage's rows, and under tensor parallelism
inside the pipeline each stacked leaf's mp range (``text.gpt.
stacked_placement``), the embeddings, ``ln_f`` and the head whole.
ZeRO-3 then keeps rows [i*n0/s, (i+1)*n0/s) of each piece whose
dimension 0 divides. ``slice_pipe_gpt_state`` is the same function with
the pipeline's arguments first. The sep axis replicates every parameter,
so a rank's piece on a mesh with sep (sharding x sep x mp, or pp x sep
with sharding or mp) is its (pp, sharding, mp) piece, whatever its sep
coordinate.
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


def _tp_rule(name):
    """(dimension, packed blocks) a TP GPT splits ``name`` along over mp,
    or None for a whole tensor."""
    if name == "gpt.wte.weight":
        return 0, 1
    if name.endswith("attn.qkv_proj.weight"):
        return 1, 3
    if name.endswith("attn.qkv_proj.bias"):
        return 0, 3
    if name.endswith("mlp.fc_in.weight"):
        return 1, 1
    if name.endswith("mlp.fc_in.bias"):
        return 0, 1
    if name.endswith(("attn.out_proj.weight", "mlp.fc_out.weight")):
        return 0, 1
    return None


def slice_gpt_state(np_state, mp_degree=1, mp_rank=0, sharding_degree=1,
                    sharding_rank=0, pp_degree=1, pp_rank=None, n_chunks=1):
    """{name: np.ndarray} of one rank's pieces, from the whole state in
    either input form (``gpt_state_from_jax``) of a ``GPTForPretraining``
    or, by its ``blocks.*`` names, a ``GPTForPretrainingPipe`` (in natural
    layer order, as the reference holds it without a pp axis).

    A stacked leaf at ``pp_degree`` > 1: its rows chunk-major when
    ``n_chunks`` > 1, as the model stores them; with ``pp_rank`` given,
    that stage's rows and, with ``mp_degree`` > 1 (tensor parallelism
    inside the pipeline), its mp range by ``text.gpt.stacked_placement``
    (the reference's ``_tp_param_specs``). A TP GPT's leaf: its piece by
    the rules of its layers (``_tp_rule``). Then, with ``sharding_degree``
    > 1, ZeRO-3's rows of each piece whose dimension 0 divides."""
    from .distributed.sharding_api import Placement, split_placement
    from .distributed.fleet.meta_parallel.spmd_pipeline import \
        interleave_row_order
    from .text.gpt import stacked_placement
    out = {}
    for name, arr in gpt_state_from_jax(np_state).items():
        if name.startswith("blocks."):
            if pp_degree > 1 and n_chunks > 1:
                arr = arr[interleave_row_order(arr.shape[0], pp_degree,
                                               n_chunks)]
            if pp_degree > 1 and pp_rank is not None:
                pl = stacked_placement(name[len("blocks."):], arr.shape,
                                       pp_degree, pp_rank, mp_degree,
                                       mp_rank)
            elif mp_degree > 1:
                raise ValueError("tensor parallelism inside the pipeline "
                                 "needs pp_degree > 1 and pp_rank")
            else:
                pl = Placement.whole(arr.shape)
        else:
            rule = _tp_rule(name)
            if rule is None or mp_degree == 1:
                pl = Placement.whole(arr.shape)
            else:
                pl = split_placement(arr.shape, rule[0], mp_degree, mp_rank,
                                     rule[1])
        piece = pl.take(arr)
        if sharding_degree > 1 and piece.ndim and \
                piece.shape[0] % sharding_degree == 0:
            rows = piece.shape[0] // sharding_degree
            piece = piece[sharding_rank * rows:(sharding_rank + 1) * rows]
        out[name] = np.ascontiguousarray(piece)
    return out


def slice_pipe_gpt_state(np_state, pp_degree=1, pp_rank=None, n_chunks=1,
                         mp_degree=1, mp_rank=0, sharding_degree=1,
                         sharding_rank=0):
    """``slice_gpt_state`` of a ``GPTForPretrainingPipe``'s whole
    natural-order state, the pipeline's arguments first: the stacked rows
    chunk-major for ``n_chunks`` > 1 (pp > 1), one stage's rows and mp
    pieces with ``pp_rank`` given, the ZeRO-3 rows at ``sharding_degree``;
    the rest whole, or its ZeRO-3 rows."""
    return slice_gpt_state(np_state, mp_degree, mp_rank, sharding_degree,
                           sharding_rank, pp_degree, pp_rank, n_chunks)
