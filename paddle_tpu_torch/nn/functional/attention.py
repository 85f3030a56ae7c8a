"""Attention functionals (counterpart: ``paddle_tpu/nn/functional/
attention.py``). Layout follows the reference's flash-attention API:
[batch, seq, num_heads, head_dim].

``scaled_dot_product_attention`` runs the flash-forward kernel (K2,
``ops/cuda_kernels.py``) where its gate admits the shapes, and the dense
``_sdpa_impl`` elsewhere — the same dense path the JAX package takes
there (for example ``generate``'s one-token steps, whose sq is not a
multiple of 128).
"""
from __future__ import annotations

import math

import torch

from ...ops import cuda_kernels as ck


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
    """[b, s, h, d] attention; the flash-forward kernel when no mask or
    dropout is asked for and the gate admits the shapes."""
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
