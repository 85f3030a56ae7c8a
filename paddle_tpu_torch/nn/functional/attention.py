"""Attention functionals (counterpart: ``paddle_tpu/nn/functional/
attention.py``). Layout follows the reference's flash-attention API:
[batch, seq, num_heads, head_dim].

``scaled_dot_product_attention`` runs the flash kernels
(``ops/cuda_kernels.py``: K2 forward, K3 backward) where their gate
admits the shapes, and the dense ``_sdpa_impl`` elsewhere — the same
dense path the JAX package takes there (for example ``generate``'s
one-token steps, whose sq is not a multiple of 128, and any call with a
mask or dropout).

``sep_parallel_attention`` is context-parallel attention over the
default mesh's sep axis (``ops/ring_attention.py``: the ring, with the
zigzag schedule for causal, or Ulysses); a mesh without one falls back to
``scaled_dot_product_attention``.

``flash_attn_unpadded`` is packed varlen attention over [T, h, d] tokens
with cu_seqlens prefix offsets: the varlen kernels (K4 forward, K5
backward) where their gate admits the call and dropout is 0, the dense
``_unpadded_impl`` elsewhere, as the JAX package routes it.
"""
from __future__ import annotations

import math

import torch

from ...ops import cuda_kernels as ck
from ...ops.dispatch import dispatch


def _sdpa_impl(q, k, v, mask, scale, is_causal):
    """Dense attention over [b, s, h, d]: GQA/MQA by repeating kv heads,
    bottom-right causal mask (row r sees columns <= r + sk - sq), softmax
    in fp32, products in q's dtype."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [b, h, s, d]
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    low = torch.finfo(logits.dtype).min
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device) \
            .tril(diagonal=sk - sq)
        logits = logits.masked_fill(~keep, low)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, low)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """[b, s, h, d] attention; the flash kernels (forward and backward)
    when no mask or dropout is asked for and the gate admits the shapes.
    It goes through the per-op seam (``ops/dispatch.py``) as op
    "scaled_dot_product_attention", so under an O2 ``auto_cast`` block in
    fp16 q, k and v arrive in fp16 and the kernels take their fp16
    route."""
    return dispatch("scaled_dot_product_attention", _sdpa_route, query, key,
                    value, attn_mask, dropout_p=dropout_p,
                    is_causal=is_causal, training=training)


def _sdpa_route(query, key, value, attn_mask, dropout_p, is_causal,
                training):
    scale = 1.0 / math.sqrt(query.shape[-1])
    if attn_mask is None and dropout_p == 0.0 and \
            ck.flash_attention_available(query, key, value,
                                         causal=is_causal):
        return ck.flash_attention_values(query, key, value,
                                         causal=is_causal, sm_scale=scale)
    out = _sdpa_impl(query, key, value, attn_mask, scale, bool(is_causal))
    if dropout_p > 0.0 and training:
        out = torch.nn.functional.dropout(out, dropout_p, training=True)
    return out


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """[b, s, h, d] attention through ``scaled_dot_product_attention``;
    returns (out, None) as the reference does."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def _unpadded_impl(q, k, v, cu_q, cu_k, scale, causal, max_seqlen_q,
                   max_seqlen_k):
    """Dense packed varlen attention: q [Tq, h, d], k/v [Tk, h, d], a
    block-diagonal mask over segment ids (searchsorted over cu_seqlens),
    causal per segment and top-left aligned (pos_q >= pos_k), masked
    logits at finfo.min, softmax in fp32, products in q's dtype."""
    tq, tk = q.shape[0], k.shape[0]
    seg_q = torch.searchsorted(
        cu_q, torch.arange(tq, device=q.device, dtype=cu_q.dtype),
        right=True)
    seg_k = torch.searchsorted(
        cu_k, torch.arange(tk, device=k.device, dtype=cu_k.dtype),
        right=True)
    logits = torch.einsum("qhd,khd->hqk", q, k) * scale
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q = torch.arange(tq, device=q.device) - cu_q[seg_q - 1]
        pos_k = torch.arange(tk, device=k.device) - cu_k[seg_k - 1]
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    logits = logits.masked_fill(~mask[None], torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", probs, v)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen (packed) attention: query/key/value [total_tokens, h, d],
    cu_seqlens [B + 1] int32 prefix sums. Returns (out, None) as the JAX
    package does. With dropout 0 and the gate admitting the call, the
    varlen kernels run: on CUDA tensors the forward launches K4 and the
    backward K5, on CPU tensors their plain versions. Otherwise (dropout,
    or causal with cu_seqlens_q unequal to cu_seqlens_k) the dense
    ``_unpadded_impl`` runs, which, as in the JAX package, applies no
    dropout."""
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    if dropout == 0.0 and ck.flash_attention_varlen_available(
            query, key, value, cu_seqlens_q, cu_seqlens_k, bool(causal)):
        out = ck.flash_attention_varlen_values(
            query, key, value, cu_seqlens_q, cu_seqlens_k, float(scale),
            bool(causal))
        return out, None
    out = _unpadded_impl(query, key, value, cu_seqlens_q, cu_seqlens_k,
                         float(scale), bool(causal), int(max_seqlen_q),
                         int(max_seqlen_k))
    return out, None


def sep_parallel_attention(query, key, value, mode="ring", is_causal=False,
                           dropout_p=0.0, training=True, name=None):
    """Context-parallel attention over the default mesh's sep axis, on
    this rank's chunk [b, s/sep, h, d] of the sequence (the rank's heads
    under tensor parallelism). ``mode`` "ring" rotates the kv chunks
    around the sep ranks (causal: the zigzag schedule when the sequence
    splits into 2·sep chunks and sk == sq; the natural chunks are
    shuffled into it and back inside); any other mode runs Ulysses' head
    exchange. A mesh without a sep axis falls back to
    ``scaled_dot_product_attention``, so model code does not depend on the
    mesh. Dropout while training is refused, as in the reference. It goes
    through the per-op seam as op "sep_parallel_attention"."""
    from ...distributed.sharding_api import get_default_mesh
    mesh = get_default_mesh()
    if mesh.shape.get("sep", 1) <= 1:
        return scaled_dot_product_attention(query, key, value,
                                            dropout_p=dropout_p,
                                            is_causal=is_causal,
                                            training=training)
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention-probability dropout is not supported under context "
            "parallelism (blockwise softmax accumulation); set dropout to 0 "
            "or disable context_parallel")
    return dispatch("sep_parallel_attention", _sep_route, query, key, value,
                    mode=mode, is_causal=bool(is_causal),
                    group=mesh.group("sep"))


def _sep_route(query, key, value, mode, is_causal, group):
    from ...ops.ring_attention import (ring_attention_values,
                                       ulysses_attention_values)
    if mode == "ring":
        return ring_attention_values(query, key, value, causal=is_causal,
                                     zigzag=False, group=group)
    return ulysses_attention_values(query, key, value, causal=is_causal,
                                    group=group)
