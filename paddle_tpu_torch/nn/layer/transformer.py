"""Transformer encoder layers (counterpart: ``paddle_tpu/nn/layer/
transformer.py``): ``MultiHeadAttention``, ``TransformerEncoderLayer``
(post-LN, or pre-LN with ``normalize_before``) and ``TransformerEncoder``.

Attention runs through ``nn.functional.scaled_dot_product_attention`` on
[b, s, h, d] heads: without a mask or dropout, and where the gate admits
the shapes, the flash kernels (K2 forward, K3 backward, non-causal); with
a mask, the dense path, as in the reference. q, k and v come from three
projections, so each is already a contiguous [b, s, h, d] tensor and the
kernels take them without a copy.

As in the reference, ``TransformerEncoder`` holds the layer it is given
and ``num_layers - 1`` deep copies of it, so every layer starts from the
same weights (upstream Paddle builds fresh layers there).

Not in this slice: the attention caches (``Cache``, ``StaticCache``,
``gen_cache``; passing ``cache`` raises), the decoder classes and
``Transformer``; ``weight_attr``/``bias_attr`` other than None raise.
"""
from __future__ import annotations

import copy

from torch import nn

from ... import resolve_device
from ...ops.math import add
from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm
from .layers import Layer


def _no_cache(cache):
    if cache is not None:
        raise NotImplementedError(
            "attention caches are not ported; they come with the decoder "
            "in a later slice of the port")


def _no_attrs(weight_attr, bias_attr):
    if weight_attr is not None or bias_attr is not None:
        raise NotImplementedError(
            "weight_attr and bias_attr are not ported; layers draw the "
            "reference's default initializers")


class MultiHeadAttention(Layer):
    """Self or cross attention over [b, s, embed_dim] inputs with separate
    q, k, v and output projections. A 3-D ``attn_mask`` [b, sq, sk] is
    broadcast over heads; a 4-D one is used as it is (bool: True keeps;
    float: added to the scores)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=None, generator=None):
        super().__init__()
        _no_attrs(weight_attr, bias_attr)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        _no_cache(cache)
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        if attn_mask is not None and attn_mask.ndim == 3:
            attn_mask = attn_mask.unsqueeze(1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        b, s = out.shape[0], out.shape[1]
        return self.out_proj(out.reshape(b, s, self.embed_dim))


class TransformerEncoderLayer(Layer):
    """Self-attention then a feed-forward block, each with a residual and
    a LayerNorm: after the sum (post-LN, the default) or before the block
    (``normalize_before``). ``activation`` names a function of the port's
    ``nn.functional`` ("relu", "gelu")."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=None,
                 generator=None):
        super().__init__()
        _no_attrs(weight_attr, bias_attr)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=device,
                               dtype=dtype)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=device,
                               dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = add(residual, self.dropout1(self.self_attn(src, src, src,
                                                         src_mask)))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """``encoder_layer`` and ``num_layers - 1`` deep copies of it, applied
    in turn, then ``norm`` when one is given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        output = src
        for layer in self.layers:
            output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output


__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]
