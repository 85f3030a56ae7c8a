"""GPT decoder transformer (counterpart: ``paddle_tpu/text/gpt.py``):
``GPTForPretraining``, and the stacked, pipelined ``StackedGPTBlocks`` and
``GPTForPretrainingPipe`` (described at their classes).

``Linear`` (``nn/layer/common.py``) keeps Paddle's [in, out] weight
layout (``y = x @ W + b``), so the port's parameters are the JAX model's
arrays as they are, and the serving engine's ``a @ W + b`` reads the
same arrays as the JAX engine's (``convert.py`` carries weights across
without a transpose). Attention runs through
``nn.functional.scaled_dot_product_attention``: the flash kernels
(forward and backward) where their gate admits the shape, the dense path
elsewhere. ``jit.CompiledTrainStep`` trains it, and so does an eager loop
under ``amp.decorate``/``amp.auto_cast``/``amp.GradScaler``.

The ops the JAX model dispatches (``embedding``, ``add``, ``layer_norm``
or ``rms_norm``, ``linear``, ``scaled_dot_product_attention``, ``gelu``,
the tied head's ``matmul`` and ``cross_entropy``) go through the per-op
seam (``ops/dispatch.py``) under the same names, so an ``auto_cast``
block casts each as the reference does (its O1 casts only the head's
``matmul``; its O2 everything but the norms and the loss).
``use_rmsnorm`` picks ``RMSNorm`` (epsilon 1e-6, weight only) for every
norm, as the reference does.

Weights are random, drawn from ``seed`` with a ``torch.Generator`` on the
CPU: embeddings and every projection at normal(0, 0.02)
(``initializer_range``), biases zero, norms one/zero. Load trained or
reference weights with ``convert.load_jax_gpt``.

``tensor_parallel`` (the reference's ``GPTConfig`` field): the
projections are ``ColumnParallelLinear``/``RowParallelLinear`` and
``wte`` a ``VocabParallelEmbedding`` over the default mesh's mp group
(``fleet.init``), each rank holding its piece. The packed qkv is split
per head within each of q, k and v (rank r keeps heads [r*nh/mp,
(r+1)*nh/mp) of each), never as one contiguous column range, and
attention runs on the rank's nh/mp heads. The tied head gives
vocab-split logits; the loss is ``ParallelCrossEntropy``, still in fp32.
``sequence_parallel`` routes the blocks through the sequence-parallel
layers: the residual stream is split over mp along the sequence between
the embedding's scatter and the final gather, and the norms and the row
biases, marked sequence-parallel, get their gradients summed over mp by
hooks. Every rank draws the whole weights from ``seed`` and keeps its
piece, so the global model is the same at every mp degree.

``context_parallel`` ("ring" or "ulysses", the reference's field): on a
mesh with a sep axis (``fleet.init`` with ``sep_degree``) each sep rank
holds its chunk of every sequence (``sharding_api.sep_local_batch``):
positions start at ``sep_rank · s_loc``, attention runs through
``nn.functional.sep_parallel_attention`` (the ring with the zigzag
schedule, or Ulysses; on the rank's heads under ``tensor_parallel``) and
the loss is the reference's global mean over the labels that are not
ignored: the rank's sum over the count summed over sep, summed over sep
(``sep_transport.loss_sum``). Its parameters are marked ``_sep_partial``,
so ``sharding.sync_gradients`` (in ``CompiledTrainStep`` and in the fleet
optimizer's step) sums their gradients over sep, ZeRO's rows included; a
model without ``context_parallel`` on a sep mesh runs the whole sequence
on every sep rank and its gradients take no such sum. A cached call
(``generate``) keeps plain attention, as in the reference; without a sep
axis the model is the plain one. With ``sequence_parallel`` as well (the
reference's sequence split over ("sep", "mp")) each sep rank's chunk is
split again over mp between the blocks: ``ScatterOp`` cuts it after the
embeddings, each column projection all-gathers it back over mp before
``sep_parallel_attention`` and the MLP, each row projection
reduce-scatters over mp, and ``GatherOp`` restores the chunk after
``ln_f``; the norms' and row biases' gradients are summed over mp by
their hooks and, with every other gradient, over sep by
``sync_gradients``, each sum once.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..nn import functional as F
from ..nn.layer.common import Linear
from ..nn.layer.norm import LayerNorm, RMSNorm
from ..ops.math import add, matmul
from ..nn.layer.layers import Layer


def _split(cfg):
    """True when the model's projections are split over mp."""
    return cfg.tensor_parallel or cfg.sequence_parallel


def _linears(cfg, device, dtype):
    """(column, row) projection constructors: ``col(i, o, packed=1)``."""
    if cfg.sequence_parallel:
        from ..distributed.fleet.utils.sequence_parallel_utils import (
            ColumnSequenceParallelLinear, RowSequenceParallelLinear)
        col = lambda i, o, packed=1: ColumnSequenceParallelLinear(  # noqa
            i, o, device=device, dtype=dtype, packed=packed)
        row = lambda i, o: RowSequenceParallelLinear(  # noqa: E731
            i, o, device=device, dtype=dtype)
        return col, row
    if cfg.tensor_parallel:
        from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                                       RowParallelLinear)
        col = lambda i, o, packed=1: ColumnParallelLinear(  # noqa: E731
            i, o, gather_output=False, device=device, dtype=dtype,
            packed=packed)
        row = lambda i, o: RowParallelLinear(  # noqa: E731
            i, o, input_is_parallel=True, device=device, dtype=dtype)
        return col, row
    col = lambda i, o, packed=1: Linear(i, o, device=device,  # noqa: E731
                                        dtype=dtype)
    return col, lambda i, o: Linear(i, o, device=device, dtype=dtype)


def _sep_group(cfg):
    """The default mesh's sep group when the model is context-parallel
    over more than one rank, else None."""
    if not cfg.context_parallel:
        return None
    from ..distributed.sharding_api import get_default_mesh
    mesh = get_default_mesh()
    return mesh.group("sep") if mesh.shape["sep"] > 1 else None


def _mp_degree(cfg):
    if not _split(cfg):
        return 1
    from ..distributed.sharding_api import get_default_mesh
    return get_default_mesh().shape["mp"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_seq_len=1024,
                 dropout=0.0, tensor_parallel=False, sequence_parallel=False,
                 context_parallel=None, use_rmsnorm=False,
                 tie_word_embeddings=True, initializer_range=0.02):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = sequence_parallel
        self.context_parallel = context_parallel
        self.use_rmsnorm = use_rmsnorm
        self.tie_word_embeddings = tie_word_embeddings
        self.initializer_range = initializer_range


class GPTAttention(Layer):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        mp = _mp_degree(cfg)
        if cfg.num_heads % mp:
            raise ValueError(f"{cfg.num_heads} heads do not split over mp "
                             f"{mp}")
        # this rank's heads (all of them without TP)
        self.num_heads = cfg.num_heads // mp
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.hidden_size = self.num_heads * self.head_dim
        col, row = _linears(cfg, device, dtype)
        self.qkv_proj = col(cfg.hidden_size, 3 * cfg.hidden_size, packed=3)
        self.out_proj = row(cfg.hidden_size, cfg.hidden_size)
        self.dropout = cfg.dropout
        self.context_parallel = cfg.context_parallel

    def forward(self, x, cache=None):
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv_proj(x)
        # under sequence parallelism the projection gathered the sequence
        b, s, _ = qkv.shape
        # column slices of the packed [b, s, 3*h*d] projection: q heads,
        # then k heads, then v heads (this rank's, under TP)
        q = qkv[:, :, :nh * hd].reshape(b, s, nh, hd)
        k = qkv[:, :, nh * hd:2 * nh * hd].reshape(b, s, nh, hd)
        v = qkv[:, :, 2 * nh * hd:].reshape(b, s, nh, hd)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            cache = (k, v)
        if self.context_parallel and cache is None:
            out = F.sep_parallel_attention(
                q, k, v, mode=self.context_parallel, is_causal=True,
                dropout_p=self.dropout, training=self.training)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout,
                training=self.training)
        out = self.out_proj(out.reshape(b, s, self.hidden_size))
        if cache is not None:
            return out, cache
        return out


class GPTMLP(Layer):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        col, row = _linears(cfg, device, dtype)
        self.fc_in = col(cfg.hidden_size, cfg.intermediate_size)
        self.fc_out = row(cfg.intermediate_size, cfg.hidden_size)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x):
        return self.drop(self.fc_out(F.gelu(self.fc_in(x),
                                            approximate=True)))


def _norm(cfg, device, dtype):
    """The block's norm: RMSNorm (epsilon 1e-6) under ``use_rmsnorm``,
    else LayerNorm (epsilon 1e-5), as in the reference."""
    if cfg.use_rmsnorm:
        return RMSNorm(cfg.hidden_size, device=device, dtype=dtype)
    return LayerNorm(cfg.hidden_size, device=device, dtype=dtype)


class GPTBlock(Layer):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.ln1 = _norm(cfg, device, dtype)
        self.attn = GPTAttention(cfg, device=device, dtype=dtype)
        self.ln2 = _norm(cfg, device, dtype)
        self.mlp = GPTMLP(cfg, device=device, dtype=dtype)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, cache=None):
        if cache is not None:
            a, cache = self.attn(self.ln1(x), cache)
        else:
            a = self.attn(self.ln1(x))
        x = add(x, self.drop(a))
        x = add(x, self.mlp(self.ln2(x)))
        if cache is not None:
            return x, cache
        return x


class GPTModel(Layer):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        if _split(config):
            from ..distributed.fleet.meta_parallel import \
                VocabParallelEmbedding
            self.wte = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, device=device,
                dtype=dtype)
        else:
            self.wte = nn.Embedding(config.vocab_size, config.hidden_size,
                                    device=device, dtype=dtype)
        self.wpe = nn.Embedding(config.max_seq_len, config.hidden_size,
                                device=device, dtype=dtype)
        self.drop = nn.Dropout(config.dropout)
        self.blocks = nn.ModuleList([GPTBlock(config, device, dtype)
                                     for _ in range(config.num_layers)])
        self.ln_f = _norm(config, device, dtype)

    def forward(self, input_ids, position_ids=None, caches=None):
        b, s = input_ids.shape
        if position_ids is None:
            # a sep rank's chunk of the sequence starts at its offset
            sep = _sep_group(self.config)
            off = sep.rank * s if sep is not None else 0
            position_ids = torch.arange(off, off + s,
                                        device=input_ids.device)[None]
        tok = self.wte(input_ids) if _split(self.config) else \
            F.embedding(input_ids, self.wte.weight)
        x = self.drop(add(tok, F.embedding(position_ids, self.wpe.weight)))
        if self.config.sequence_parallel:
            from ..distributed.fleet.utils.sequence_parallel_utils import \
                ScatterOp
            x = ScatterOp.apply(x)
        new_caches = [] if caches is not None else None
        for i, block in enumerate(self.blocks):
            if caches is not None:
                x, c = block(x, caches[i])
                new_caches.append(c)
            else:
                x = block(x)
        x = self.ln_f(x)
        if self.config.sequence_parallel:
            from ..distributed.fleet.utils.sequence_parallel_utils import \
                GatherOp
            x = GatherOp.apply(x)
        if caches is not None:
            return x, new_caches
        return x


class GPTForPretraining(Layer):
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
        if config.context_parallel:
            # on a sep mesh each rank's gradient is its chunk's share of
            # the global loss's: sharding.sync_gradients sums it over sep
            for p in self.parameters():
                p._sep_partial = True
        if config.sequence_parallel:
            from ..distributed.fleet.utils.sequence_parallel_utils import (
                mark_as_sequence_parallel_parameter,
                register_sequence_parallel_allreduce_hooks)
            # the norms act on the rank's rows of the sequence
            for name, p in self.named_parameters():
                if ".ln" in name:
                    mark_as_sequence_parallel_parameter(p)
            register_sequence_parallel_allreduce_hooks(self)

    @torch.no_grad()
    def _init_weights(self, seed):
        """Every rank draws each whole tensor in one order and keeps its
        piece, so the global weights do not depend on the mp degree."""
        gen = torch.Generator().manual_seed(int(seed))
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln" in name:
                p.fill_(1.0)
            else:
                pl = getattr(p, "_placement", None)
                shape = pl.global_shape if pl is not None else p.shape
                full = torch.normal(0.0, std, shape, generator=gen)
                p.copy_(pl.take(full) if pl is not None else full)

    @property
    def device(self):
        return self.gpt.wte.weight.device

    def _logits(self, hidden):
        if self.config.tie_word_embeddings:
            if _split(self.config):
                # the vocab-split head: the hidden's gradient is summed
                # over the mp ranks' vocabulary pieces
                from ..distributed.fleet.meta_parallel.mp_layers import \
                    c_identity
                hidden = c_identity(hidden)
            return matmul(hidden, self.gpt.wte.weight, transpose_y=True)
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None, position_ids=None):
        logits = self._logits(self.gpt(input_ids, position_ids))
        if labels is None:
            return logits
        sep = _sep_group(self.config)
        if _split(self.config) and self.config.tie_word_embeddings:
            from ..distributed.fleet.meta_parallel import \
                ParallelCrossEntropy
            total = ParallelCrossEntropy()(logits.float(), labels).sum()
        elif sep is not None:
            total = F.cross_entropy(
                logits.reshape(-1, logits.shape[-1]).float(),
                labels.reshape(-1), reduction="sum")
        else:
            # in fp32: under O2 the JAX loss works in the low dtype
            # (ROADMAP C)
            return logits, F.cross_entropy(
                logits.reshape(-1, logits.shape[-1]).float(),
                labels.reshape(-1))
        count = (labels != -100).sum()
        if sep is not None:
            # the global mean: every sep rank's sum over the whole count
            from ..distributed import sep_transport
            from ..distributed.collective import all_reduce
            all_reduce(count, group=sep)
            total = sep_transport.loss_sum(total, sep)
        return logits, total / torch.clamp(count, min=1)

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
        if _split(cfg):
            raise NotImplementedError(
                "generate under tensor_parallel/sequence_parallel (its "
                "logits are split over the vocabulary) is not ported")
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

    def num_parameters(self):
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self):
        """6N + attention term, as the JAX package counts it, so MFU
        means the same thing in both packages."""
        n = self.num_parameters()
        cfg = self.config
        attn = 12 * cfg.num_layers * cfg.hidden_size * cfg.max_seq_len
        return 6 * n + attn


def gpt_small(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt_medium(**kw):
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def gpt_large(**kw):
    return GPTConfig(hidden_size=1536, num_layers=24, num_heads=16, **kw)


def gpt3_6_7b(**kw):
    return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32, **kw)


# -- the stacked blocks and the pipelined GPT ---------------------------------

_STACKED_ORDER = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b",
                  "ln2_w", "ln2_b", "fc_in_w", "fc_in_b", "fc_out_w",
                  "fc_out_b")


# the reference's ``_tp_param_specs``: the dimension of each stacked leaf
# split over mp under tensor parallelism inside the pipeline (qkv and
# fc_in column-parallel on their trailing axis, out and fc_out
# row-parallel), None for a leaf replicated over mp (the norms and the
# row-parallel biases, which add after the mp sum)
_TP_DIM = {"ln1_w": None, "ln1_b": None, "qkv_w": 3, "qkv_b": 2,
           "out_w": 1, "out_b": None, "ln2_w": None, "ln2_b": None,
           "fc_in_w": 2, "fc_in_b": 1, "fc_out_w": 1, "fc_out_b": None}


def _pp_group():
    """The default mesh's pp group when it has more than one rank."""
    from ..distributed.sharding_api import peek_default_mesh
    mesh = peek_default_mesh()
    if mesh is None or mesh.shape["pp"] == 1:
        return None
    return mesh.group("pp")


def stacked_placement(name, shape, pp=1, stage=0, mp=1, mp_rank=0):
    """The ``Placement`` of a rank's piece of the stacked leaf ``name``
    (``qkv_w``, ...; global ``shape``, rows as stored): rows
    [stage·L/pp, (stage+1)·L/pp) over pp and, with ``mp`` > 1, range
    ``mp_rank`` of ``mp`` of the leaf's ``_TP_DIM`` over mp. qkv's
    trailing range takes whole heads of each of q, k and v."""
    from ..distributed.sharding_api import Placement
    pl = Placement.whole(shape)
    if pp > 1:
        rows = shape[0] // pp
        pl = pl.narrow(0, stage * rows, (stage + 1) * rows, "pp")
    d = _TP_DIM[name]
    if mp > 1 and d is not None:
        w = shape[d] // mp
        pl = pl.narrow(d, mp_rank * w, (mp_rank + 1) * w, "mp")
    return pl


def _stacked_init(name, shape, std, gen):
    """The reference's init of a stacked tensor: norms' weights one,
    biases zero, the rest normal(0, std)."""
    if name in ("ln1_w", "ln2_w"):
        return torch.ones(shape)
    if name.endswith("_b"):
        return torch.zeros(shape)
    return torch.normal(0.0, std, shape, generator=gen)


class StackedGPTBlocks(Layer):
    """All transformer blocks as stacked parameters, the layer on
    dimension 0: ``qkv_w`` [L, H, 3, H], ``qkv_b`` [L, 3, H], ``out_w``
    [L, H, H], ``fc_in_w`` [L, H, FF], ``fc_out_w`` [L, FF, H], the norms
    and the other biases [L, H] or [L, FF] (``_param_order``). The block
    is the reference's ``_block_fn``: pre-norm (LayerNorm at epsilon
    1e-5, or RMSNorm at 1e-6), the qkv split by columns, causal attention
    through K2/K3 (``flash_attention_values``) where their gate admits the
    shape and the plain attention elsewhere, ``gelu(approximate=True)``,
    the biases added after the row products. No dropout.

    On a mesh with pp > 1 the layers run as the SPMD pipeline
    (``fleet/meta_parallel/spmd_pipeline.py``) over the pp group;
    otherwise in natural layer order. With ``n_chunks`` > 1 on such a mesh
    the rows are stored chunk-major (``interleave_row_order``), so each
    stage's rows are contiguous; ``state_dict`` holds that layout.
    ``commit_param_shardings`` keeps this rank's piece of each leaf
    (``stacked_placement``: a pp rank's ``state_dict`` returns its rows,
    their ``Placement`` the global shape), as ``CompiledTrainStep`` and
    ``group_sharded_parallel`` do first.

    ``tensor_parallel`` inside the pipeline (pp and mp above 1, the
    reference's ``_tp_param_specs``): qkv and fc_in are split over mp on
    their trailing axis (whole heads of each of q, k and v a rank), out
    and fc_out on their rows, and the norms and the row-parallel biases
    stay whole on every mp rank; a committed rank holds only its rows and
    its columns or rows. The block sums the attention and MLP outputs over
    mp (``mp_layers.mp_allreduce``, the biases added after the sum) and
    the gradients of the column-parallel inputs (``c_identity``), inside
    the tick loop, metered by ``mp_layers.comm_meter``. On a mesh that
    cannot honour it (no pp or no mp axis), ``tensor_parallel`` warns once
    and is ignored, as in the reference."""

    def __init__(self, cfg, n_chunks=1, device=None, dtype=torch.float32,
                 seed=0, generator=None):
        super().__init__()
        if cfg.dropout:
            raise ValueError(
                "StackedGPTBlocks does not support dropout; set dropout=0 "
                "or use GPTForPretraining")
        device = resolve_device(device)
        self.tensor_parallel = bool(cfg.tensor_parallel)
        L, H, FF = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
        self.num_layers = L
        self.num_heads = cfg.num_heads
        self.head_dim = H // cfg.num_heads
        self.use_rmsnorm = cfg.use_rmsnorm
        self._param_order = _STACKED_ORDER
        shapes = {"ln1_w": [L, H], "ln1_b": [L, H], "qkv_w": [L, H, 3, H],
                  "qkv_b": [L, 3, H], "out_w": [L, H, H], "out_b": [L, H],
                  "ln2_w": [L, H], "ln2_b": [L, H], "fc_in_w": [L, H, FF],
                  "fc_in_b": [L, FF], "fc_out_w": [L, FF, H],
                  "fc_out_b": [L, H]}
        self._shapes = {k: tuple(v) for k, v in shapes.items()}
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(int(seed))
        for name in self._param_order:
            value = _stacked_init(name, shapes[name], cfg.initializer_range,
                                  gen)
            setattr(self, name, nn.Parameter(value.to(device=device,
                                                      dtype=dtype)))
        self._n_chunks = 1
        self._inv_order = None
        self._stage = None
        group = _pp_group()
        if n_chunks > 1 and group is not None:
            from ..distributed.fleet.meta_parallel.spmd_pipeline import \
                interleave_row_order
            order = interleave_row_order(L, group.nranks, n_chunks)
            with torch.no_grad():
                for name in self._param_order:
                    p = getattr(self, name)
                    p.data = p.data[torch.as_tensor(order)].contiguous()
            self._n_chunks = n_chunks
            self._inv_order = torch.as_tensor(np.argsort(order))

    def _params(self):
        return tuple(getattr(self, n) for n in self._param_order)

    def _block(self, p, x, tp=None):
        """One layer on this rank's leaves; ``tp``, the mp group under
        tensor parallelism (the leaves its pieces: ``hloc`` = H/mp columns
        of each of q, k and v)."""
        from ..distributed.fleet.meta_parallel.mp_layers import (
            c_identity, mp_allreduce)
        (ln1w, ln1b, qkvw, qkvb, outw, outb,
         ln2w, ln2b, fiw, fib, fow, fob) = p
        b, s, _ = x.shape
        hd = self.head_dim
        hin, _, hloc = qkvw.shape[-3:]
        a = self._ln(x, ln1w, ln1b)
        if tp is not None:
            a = c_identity(a, tp)
        qkv = a @ qkvw.reshape(hin, 3 * hloc) + qkvb.reshape(3 * hloc)
        nh = hloc // hd
        q = qkv[..., :hloc].reshape(b, s, nh, hd)
        k = qkv[..., hloc:2 * hloc].reshape(b, s, nh, hd)
        v = qkv[..., 2 * hloc:].reshape(b, s, nh, hd)
        from ..nn.functional.attention import _sdpa_impl
        from ..ops import cuda_kernels as ck
        if ck.flash_attention_available(q, k, v, causal=True):
            o = ck.flash_attention_values(q, k, v, causal=True)
        else:
            o = _sdpa_impl(q, k, v, None, 1.0 / math.sqrt(hd), True)
        o = o.reshape(b, s, hloc) @ outw
        if tp is not None:
            o = mp_allreduce(o, tp)
        x = x + o + outb
        a = self._ln(x, ln2w, ln2b)
        if tp is not None:
            a = c_identity(a, tp)
        a = torch.nn.functional.gelu(a @ fiw + fib, approximate="tanh")
        m = a @ fow
        if tp is not None:
            m = mp_allreduce(m, tp)
        return x + m + fob

    def _ln(self, x, w, b):
        if self.use_rmsnorm:
            ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
            return x * torch.rsqrt(ms + 1e-6) * w
        m = torch.mean(x, dim=-1, keepdim=True)
        v = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        return (x - m) * torch.rsqrt(v + 1e-5) * w + b

    def _tp(self):
        """(mp degree, this rank's mp index) of the blocks' split: the
        default mesh's under ``tensor_parallel`` inside the pipeline (pp
        and mp above 1), else (1, 0); warns once when ``tensor_parallel``
        is set and the mesh cannot honour it."""
        from ..distributed.sharding_api import peek_default_mesh
        mesh = peek_default_mesh()
        pp, mp = (mesh.shape["pp"], mesh.shape["mp"]) if mesh is not None \
            else (1, 1)
        if not self.tensor_parallel:
            return 1, 0
        if pp > 1 and mp > 1:
            if self.num_heads % mp:
                raise ValueError(f"{self.num_heads} heads do not split "
                                 f"over mp {mp}")
            return mp, mesh.coord["mp"]
        if not getattr(self, "_tp_warned", False):
            import warnings
            warnings.warn(
                "StackedGPTBlocks: tensor_parallel=True has no effect on "
                f"this mesh (pp={pp}, mp={mp}); "
                "weights stay replicated. TP-in-pipeline needs pp>1 and "
                "mp>1; for TP without a pipeline use GPTForPretraining "
                "(mp_layers).", UserWarning, stacklevel=3)
            self._tp_warned = True
        return 1, 0

    def _placements(self):
        """Each leaf's ``stacked_placement`` on this rank of the default
        mesh (its pp coordinate is its stage)."""
        from ..distributed.sharding_api import peek_default_mesh
        mesh = peek_default_mesh()
        mp, mp_rank = self._tp()
        return tuple(stacked_placement(name, self._shapes[name],
                                       mesh.shape["pp"], mesh.coord["pp"],
                                       mp, mp_rank)
                     for name in self._param_order)

    @torch.no_grad()
    def commit_param_shardings(self):
        """Keep this rank's piece of each leaf (a no-op without a pp axis,
        and once done): its stage's rows, and under tensor parallelism its
        mp range, with their ``Placement`` (over pp, and mp for a split
        leaf, which is marked ``is_distributed``)."""
        from ..distributed.sharding_api import peek_default_mesh, place
        group = _pp_group()
        if group is None or self._stage is not None:
            return
        stage = peek_default_mesh().coord["pp"]
        if self.num_layers % group.nranks:
            raise ValueError(f"{self.num_layers} layers do not split over "
                             f"pp {group.nranks}")
        for p, pl in zip(self._params(), self._placements()):
            p.data = pl.take(p.data)
            place(p, pl)
            p._pp_stage = stage
            if "mp" in pl.axes:
                p.is_distributed = True
        self._stage = stage

    def forward(self, x, n_microbatch=None, remat=False):
        group = _pp_group()
        mp, _ = self._tp()
        params = self._params()
        if group is not None:
            from ..distributed.fleet.meta_parallel.spmd_pipeline import \
                spmd_pipeline
            from ..distributed.sharding_api import peek_default_mesh
            block = self._block if mp == 1 else functools.partial(
                self._block, tp=peek_default_mesh().group("mp"))
            return spmd_pipeline(block, params, x,
                                 n_microbatch or group.nranks, group,
                                 n_chunks=self._n_chunks, remat=remat,
                                 param_rows=self.num_layers,
                                 param_specs=self._placements())
        if self._inv_order is not None:
            # chunk-major storage; the sequential loop runs natural order
            params = tuple(p[self._inv_order.to(p.device)] for p in params)
        for layer in range(params[0].shape[0]):
            x = self._block(tuple(p[layer] for p in params), x)
        return x


class _LossShare(torch.autograd.Function):
    """The loss as it is; its gradient divided by the pp degree: every pp
    rank computes the same loss from the broadcast output, so each
    differentiates its 1/pp share and the sum over pp
    (``sharding.sync_gradients``) counts the head once."""

    @staticmethod
    def forward(ctx, loss, n):
        ctx.n = n
        return loss.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


class GPTForPretrainingPipe(Layer):
    """The pipeline-parallel GPT: the embeddings, ``ln_f`` and the head
    (tied to ``wte`` or not) run on every pp rank, outside the pipelined
    ``StackedGPTBlocks``. ``n_chunks`` > 1 picks the interleaved schedule,
    ``remat`` recomputes each tick's chunk in the backward, ``labels``
    give ``(logits, loss)`` (the loss in fp32, as ``GPTForPretraining``'s).

    On a pp mesh the output of the blocks is the last stage's, broadcast
    to every rank, so every rank computes the same loss; each takes 1/pp
    of its gradient, and ``sharding.sync_gradients`` sums the parameters
    outside the pipeline (marked ``_pp_replicated``) over pp: a tied
    ``wte`` gets its head part from every rank's share and its embedding
    part from stage 0 alone, each counted once. A stacked row's gradient
    is its own stage's. Under ``tensor_parallel`` on a mesh with pp and mp
    the blocks are split over mp (``StackedGPTBlocks``) while the
    embeddings, ``ln_f`` and the head stay whole on every pp and mp rank:
    every mp rank computes the same loss, so their gradients take no sum
    over mp, and ZeRO (``group_sharded_parallel``) shards them over
    sharding. On a mesh with sep as well (pp x sep, with sharding or mp)
    the batch stays split over the data axes only, as in the reference's
    SPMD pipeline: every sep rank runs the whole sequence through its pp
    group, so its gradients are the whole ones and take no sum over sep
    (the parameters are not marked ``_sep_partial``). ``context_parallel``
    is not read by the pipelined blocks, as in the reference. Weights are
    drawn from ``seed`` in parameter order on the CPU (normal(0,
    ``initializer_range``), biases zero, norms one), the same on every
    rank."""

    def __init__(self, config, n_microbatch=None, n_chunks=1, remat=False,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.n_microbatch = n_microbatch
        self.n_chunks = n_chunks
        self.remat = remat
        gen = torch.Generator().manual_seed(int(seed))
        std = config.initializer_range
        V, H = config.vocab_size, config.hidden_size
        self.wte = nn.Embedding(V, H, device=device, dtype=dtype)
        self.wpe = nn.Embedding(config.max_seq_len, H, device=device,
                                dtype=dtype)
        with torch.no_grad():
            for emb in (self.wte, self.wpe):
                emb.weight.copy_(torch.normal(0.0, std,
                                              tuple(emb.weight.shape),
                                              generator=gen))
        self.blocks = StackedGPTBlocks(config, n_chunks=n_chunks,
                                       device=device, dtype=dtype,
                                       generator=gen)
        self.ln_f = _norm(config, device, dtype)
        if not config.tie_word_embeddings:
            self.lm_head = Linear(H, V, bias=False, device=device,
                                  dtype=dtype)
            with torch.no_grad():
                self.lm_head.weight.copy_(torch.normal(0.0, std, (H, V),
                                                       generator=gen))
        for name, p in self.named_parameters():
            if not name.startswith("blocks."):
                p._pp_replicated = True

    @property
    def device(self):
        return self.wte.weight.device

    def forward(self, input_ids, labels=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        x = add(F.embedding(input_ids, self.wte.weight),
                F.embedding(position_ids, self.wpe.weight))
        x = self.blocks(x, n_microbatch=self.n_microbatch, remat=self.remat)
        x = self.ln_f(x)
        if self.config.tie_word_embeddings:
            logits = matmul(x, self.wte.weight, transpose_y=True)
        else:
            logits = self.lm_head(x)
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               labels.reshape(-1))
        group = _pp_group()
        if group is not None:
            loss = _LossShare.apply(loss, group.nranks)
        return logits, loss

    def commit_param_shardings(self):
        """The blocks' pieces of this rank (its stage's rows, and its mp
        ranges under tensor parallelism); the rest stays whole on every pp
        and mp rank."""
        self.blocks.commit_param_shardings()

    def num_parameters(self):
        return sum(p.numel() for p in self.parameters())

    flops_per_token = GPTForPretraining.flops_per_token
