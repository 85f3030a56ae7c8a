"""GPT decoder transformer (counterpart: ``paddle_tpu/text/gpt.py``,
the non-tensor-parallel ``GPTForPretraining`` family; no stacked or
pipelined variant in this slice).

``Linear`` keeps Paddle's [in, out] weight layout (``y = x @ W + b``), so
the port's parameters are the JAX model's arrays as they are, and the
serving engine's ``a @ W + b`` reads the same arrays as the JAX engine's
(``convert.py`` carries weights across without a transpose). Attention
runs through ``nn.functional.scaled_dot_product_attention``: the
flash-forward kernel where its gate admits the shape, the dense path
elsewhere.

Weights are random, drawn from ``seed`` with a ``torch.Generator`` on the
CPU: embeddings and every projection at normal(0, 0.02)
(``initializer_range``), biases zero, norms one/zero. Load trained or
reference weights with ``convert.load_jax_gpt``.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..nn import functional as F


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_seq_len=1024,
                 dropout=0.0, use_rmsnorm=False, tie_word_embeddings=True,
                 initializer_range=0.02):
        if use_rmsnorm:
            raise NotImplementedError(
                "the port's GPT has LayerNorm blocks; RMSNorm comes with a "
                "later slice")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.use_rmsnorm = use_rmsnorm
        self.tie_word_embeddings = tie_word_embeddings
        self.initializer_range = initializer_range


class Linear(nn.Module):
    """``y = x @ weight + bias`` with weight [in, out] (Paddle's layout)."""

    def __init__(self, in_features, out_features, bias=True, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device,
                                             dtype=dtype)) if bias else None

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class GPTAttention(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.hidden_size = cfg.hidden_size
        self.qkv_proj = Linear(cfg.hidden_size, 3 * cfg.hidden_size,
                               device=device, dtype=dtype)
        self.out_proj = Linear(cfg.hidden_size, cfg.hidden_size,
                               device=device, dtype=dtype)
        self.dropout = cfg.dropout

    def forward(self, x, cache=None):
        b, s, _ = x.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv_proj(x)
        # column slices of the packed [b, s, 3*h*d] projection: q heads,
        # then k heads, then v heads
        q = qkv[:, :, :nh * hd].reshape(b, s, nh, hd)
        k = qkv[:, :, nh * hd:2 * nh * hd].reshape(b, s, nh, hd)
        v = qkv[:, :, 2 * nh * hd:].reshape(b, s, nh, hd)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            cache = (k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(b, s, self.hidden_size))
        if cache is not None:
            return out, cache
        return out


class GPTMLP(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.fc_in = Linear(cfg.hidden_size, cfg.intermediate_size,
                            device=device, dtype=dtype)
        self.fc_out = Linear(cfg.intermediate_size, cfg.hidden_size,
                             device=device, dtype=dtype)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x):
        return self.drop(self.fc_out(torch.nn.functional.gelu(
            self.fc_in(x), approximate="tanh")))


class GPTBlock(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, device=device,
                                dtype=dtype)
        self.attn = GPTAttention(cfg, device=device, dtype=dtype)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, device=device,
                                dtype=dtype)
        self.mlp = GPTMLP(cfg, device=device, dtype=dtype)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, cache=None):
        if cache is not None:
            a, cache = self.attn(self.ln1(x), cache)
        else:
            a = self.attn(self.ln1(x))
        x = x + self.drop(a)
        x = x + self.mlp(self.ln2(x))
        if cache is not None:
            return x, cache
        return x


class GPTModel(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size,
                                device=device, dtype=dtype)
        self.wpe = nn.Embedding(config.max_seq_len, config.hidden_size,
                                device=device, dtype=dtype)
        self.drop = nn.Dropout(config.dropout)
        self.blocks = nn.ModuleList([GPTBlock(config, device, dtype)
                                     for _ in range(config.num_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size, eps=1e-5,
                                 device=device, dtype=dtype)

    def forward(self, input_ids, position_ids=None, caches=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        new_caches = [] if caches is not None else None
        for i, block in enumerate(self.blocks):
            if caches is not None:
                x, c = block(x, caches[i])
                new_caches.append(c)
            else:
                x = block(x)
        x = self.ln_f(x)
        if caches is not None:
            return x, new_caches
        return x


class GPTForPretraining(nn.Module):
    """GPT with a language-model head (tied to ``wte`` by default).

    ``device`` follows the port's rule: "cuda" unless ``device="cpu"`` is
    passed; without a card and without that, construction raises.
    """

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, device, dtype)
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias=False, device=device, dtype=dtype)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed):
        gen = torch.Generator().manual_seed(int(seed))
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln" in name:
                p.fill_(1.0)
            else:
                p.copy_(torch.normal(0.0, std, p.shape, generator=gen))

    @property
    def device(self):
        return self.gpt.wte.weight.device

    def _logits(self, hidden):
        if self.config.tie_word_embeddings:
            return hidden @ self.gpt.wte.weight.t()
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None, position_ids=None):
        logits = self._logits(self.gpt(input_ids, position_ids))
        if labels is not None:
            loss = torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]).float(),
                labels.reshape(-1))
            return logits, loss
        return logits

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=20, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 seed=None):
        """KV-cached autoregressive decoding: one prefill pass over the
        prompt (the flash-forward kernel when its gate admits the prompt
        length), then one cached step per new token. Greedy by default;
        with ``do_sample`` each draw uses the serving sampler's rule,
        keyed by (seed, absolute position)."""
        from ..inference.serving.sampling import sample_tokens
        cfg = self.config
        b, s = input_ids.shape
        dev = input_ids.device
        hd = cfg.hidden_size // cfg.num_heads
        empty = torch.zeros((b, 0, cfg.num_heads, hd),
                            dtype=self.gpt.wte.weight.dtype, device=dev)
        caches = [(empty, empty) for _ in range(cfg.num_layers)]
        pos = torch.arange(s, device=dev)[None]
        hidden, caches = self.gpt(input_ids, pos, caches=caches)
        if do_sample and seed is None:
            seed = int(torch.randint(0, 2 ** 31 - 1, ()).item())
        out_tokens = [input_ids]
        cur = s
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        for _ in range(max_new_tokens):
            logits = self._logits(hidden)[:, -1, :]
            if do_sample:
                full = lambda v, dt: torch.full((b,), v, dtype=dt,
                                                device=dev)
                nxt = sample_tokens(
                    logits, full(seed, torch.int64),
                    full(cur, torch.int64),
                    full(max(temperature, 1e-6), torch.float32),
                    full(int(top_k or 0), torch.int64),
                    full(top_p, torch.float32)).long()
            else:
                nxt = logits.argmax(dim=-1)
            if eos_token_id is not None:
                nxt = torch.where(finished, torch.full_like(
                    nxt, eos_token_id), nxt)
                finished = finished | (nxt == eos_token_id)
            out_tokens.append(nxt[:, None])
            if eos_token_id is not None and bool(finished.all()):
                break
            pos = torch.full((b, 1), cur, dtype=torch.long, device=dev)
            hidden, caches = self.gpt(nxt[:, None], pos, caches=caches)
            cur += 1
        return torch.cat(out_tokens, dim=1)



def gpt_small(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt_medium(**kw):
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def gpt_large(**kw):
    return GPTConfig(hidden_size=1536, num_layers=24, num_heads=16, **kw)


def gpt3_6_7b(**kw):
    return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32, **kw)
