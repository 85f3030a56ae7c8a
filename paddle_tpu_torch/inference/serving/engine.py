"""Serving engine: prefill, decode and speculative verify over the paged
KV cache (counterpart: ``paddle_tpu/inference/serving/engine.py``).

The engine adapts a ``paddle_tpu_torch.text.gpt.GPTForPretraining`` into
three step functions over its parameter tensors:

- ``decode_step`` — one step for the whole decode batch: embed each
  slot's current token, per layer project qkv, write the new K/V rows
  into their (page, offset) slots, attend over the block tables through
  the paged-attention kernel (K1, ``ops/cuda_kernels.py``), and draw the
  next token per slot;
- ``verify_step`` — the speculative form: k drafted tokens plus the bonus
  position per slot in one pass, K1 with k + 1 query rows per slot, and
  the batched acceptance count;
- ``prefill_step`` — one prompt's un-cached tail runs densely (causal),
  reading any prefix-cache hit straight out of the shared pages, writes
  the tail's K/V into pages and draws the first token. The tail runs at
  its exact length: PyTorch runs eagerly, so the JAX engine's padding to
  compile buckets has no counterpart here.

The pools are written IN PLACE with ``index_put_`` (the JAX engine
donates them to its programs instead). Inactive slots all write into the
null page 0 at offset 0; which of those writes wins is left open, and
page 0 is only ever read under a mask. The block tables, context
lengths, slot pages and offsets reach the kernel as contiguous int32 on
the device. Each step reads its tokens back with one host transfer.

Decode and verify read their per-step inputs from one int32 and one fp32
device buffer per program, filled from a (pinned, on the card) host
staging buffer with one copy each. On CUDA those buffers are the static
inputs of the CUDA graphs ``compile_cache.py`` captures at init and
holds to the eager steps: decode at (max_batch, KQ = 1), verify at
(max_batch, KQ = spec_k + 1); each step then copies its inputs in and
replays. A compile cache directory (``compile_cache_dir`` or
``PADDLE_SERVE_COMPILE_CACHE``) keeps the checked programs' manifests,
so engines over it skip the check. Prefill stays eager (it runs at the
tail's exact length, so it has no shape to capture). On the CPU every
step runs eagerly.

Instrumentation: ``serve.step`` / ``serve.admit`` / ``serve.prefill`` /
``serve.decode_step`` / ``serve.verify_step`` spans; TTFT/TPOT
histograms, occupancy and free-page gauges, prefix and token counters.

Env knobs (docs/SERVING.md): ``PADDLE_SERVE_PAGE_SIZE`` (default 16),
``PADDLE_SERVE_NUM_PAGES``, ``PADDLE_SERVE_MAX_BATCH`` (default 8),
``PADDLE_SERVE_PREFILL_BUDGET`` (tokens/step, default 512),
``PADDLE_SERVE_PREFIX_CACHE`` (default on), ``PADDLE_SERVE_SPEC_K``,
``PADDLE_SERVE_SPEC_NGRAM``, ``PADDLE_SERVE_QUEUE_LIMIT``,
``PADDLE_SERVE_COMPILE_CACHE``.
"""
from __future__ import annotations

import math
import os

import torch

from ... import resolve_device
from ...observability import metrics, trace
from ...ops import cuda_kernels as ck
from . import compile_cache
from .kv_cache import PagedKVCache
from .prefix_cache import PrefixCache
from .sampling import sample_tokens
from .scheduler import Request, RequestTooLarge, Scheduler

SERVE_TTFT_MS = metrics.histogram(
    "serving_ttft_ms", "time to first token per request")
SERVE_TPOT_MS = metrics.histogram(
    "serving_tpot_ms", "mean time per output token after the first")
SERVE_OCCUPANCY = metrics.gauge(
    "serving_batch_occupancy", "running sequences in the decode batch")
SERVE_FREE_PAGES = metrics.gauge(
    "serving_free_pages", "KV pages on the free list")
SERVE_TOKENS = metrics.counter(
    "serving_tokens_generated", "output tokens emitted")
SERVE_PREFILL_TOKENS = metrics.counter(
    "serving_prefill_tokens", "prompt tokens prefilled (cache misses)")
SERVE_PREFIX_HITS = metrics.counter(
    "serving_prefix_hits", "prompt lookups that reused cached pages")
SERVE_PREFIX_LOOKUPS = metrics.counter(
    "serving_prefix_lookups", "prompt lookups against the prefix cache")
SERVE_PREFIX_TOKENS_SKIPPED = metrics.counter(
    "serving_prefix_tokens_skipped", "prompt tokens whose prefill was "
    "skipped via prefix-cache hits")
SERVE_SPEC_STEPS = metrics.counter(
    "serving_spec_verify_steps", "speculative verify dispatches (one "
    "per engine step per active sequence)")
SERVE_SPEC_ACCEPTED = metrics.counter(
    "serving_spec_accepted_tokens", "draft tokens accepted by verify "
    "dispatches (committed bonus tokens not included)")
SERVE_SPEC_ROLLBACK_PAGES = metrics.counter(
    "serving_spec_rollback_pages", "KV pages freed by block-table "
    "truncation after rejected drafts")


class ServingConfig:
    def __init__(self, page_size=None, num_pages=None, max_batch=None,
                 prefill_token_budget=None, prefix_caching=None,
                 max_model_len=None, kv_dtype=None, spec_k=None,
                 spec_ngram=None, compile_cache_dir=None, queue_limit=None):
        env = os.environ.get
        self.page_size = int(page_size or env("PADDLE_SERVE_PAGE_SIZE", 16))
        # compile cache: where the manifests of checked step graphs are
        # kept, shared by every replica reading the directory
        self.compile_cache_dir = compile_cache_dir \
            if compile_cache_dir is not None \
            else (env("PADDLE_SERVE_COMPILE_CACHE", "") or None)
        self.max_batch = int(max_batch or env("PADDLE_SERVE_MAX_BATCH", 8))
        self.prefill_token_budget = int(
            prefill_token_budget or env("PADDLE_SERVE_PREFILL_BUDGET", 512))
        if prefix_caching is None:
            prefix_caching = str(env("PADDLE_SERVE_PREFIX_CACHE", "1")) \
                .lower() not in ("0", "false", "off")
        self.prefix_caching = bool(prefix_caching)
        self.num_pages = num_pages if num_pages is None \
            else int(num_pages)
        if self.num_pages is None and env("PADDLE_SERVE_NUM_PAGES"):
            self.num_pages = int(env("PADDLE_SERVE_NUM_PAGES"))
        self.max_model_len = max_model_len    # default: model max_seq_len
        self.kv_dtype = kv_dtype              # default: model param dtype
        # speculative decoding: spec_k > 0 switches the decode loop to
        # k-token draft/verify steps; 0 keeps one token per step
        self.spec_k = int(spec_k if spec_k is not None
                          else env("PADDLE_SERVE_SPEC_K", 0))
        self.spec_ngram = int(spec_ngram if spec_ngram is not None
                              else env("PADDLE_SERVE_SPEC_NGRAM", 3))
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        # admission control: bound on the scheduler's waiting queue
        # (0 = unbounded); submits past it raise EngineOverloaded
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else env("PADDLE_SERVE_QUEUE_LIMIT", 0))
        if self.queue_limit < 0:
            raise ValueError("queue_limit must be >= 0")


def _ln(x, w, b):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def extract_gpt_params(model):
    """The model's weights as a dict of tensors (no copies): what the
    step functions read. Supports ``GPTForPretraining`` with LayerNorm
    blocks and tied or untied heads."""
    if model.config.use_rmsnorm:
        raise NotImplementedError("serving engine v1 supports LayerNorm "
                                  "GPT configs")
    g = model.gpt
    params = {
        "wte": g.wte.weight, "wpe": g.wpe.weight,
        "lnf_w": g.ln_f.weight, "lnf_b": g.ln_f.bias, "blocks": [],
    }
    for blk in g.blocks:
        params["blocks"].append({
            "ln1_w": blk.ln1.weight, "ln1_b": blk.ln1.bias,
            "qkv_w": blk.attn.qkv_proj.weight,
            "qkv_b": blk.attn.qkv_proj.bias,
            "out_w": blk.attn.out_proj.weight,
            "out_b": blk.attn.out_proj.bias,
            "ln2_w": blk.ln2.weight, "ln2_b": blk.ln2.bias,
            "fi_w": blk.mlp.fc_in.weight, "fi_b": blk.mlp.fc_in.bias,
            "fo_w": blk.mlp.fc_out.weight, "fo_b": blk.mlp.fc_out.bias,
        })
    if not model.config.tie_word_embeddings:
        params["head_w"] = model.lm_head.weight
    return params


def _flat(rows):
    return [v for row in rows for v in row]


def _head(params, x):
    if "head_w" in params:
        return x @ params["head_w"]
    return x @ params["wte"].t()


def _mlp(bp, x):
    a2 = _ln(x, bp["ln2_w"], bp["ln2_b"])
    return x + _gelu(a2 @ bp["fi_w"] + bp["fi_b"]) @ bp["fo_w"] + bp["fo_b"]


@torch.no_grad()
def decode_step(params, k_pool, v_pool, tokens, positions, block_tables,
                ctx_lens, slot_pages, slot_offsets, seeds, temps, top_ks,
                top_ps, num_heads):
    """One decode step for the batch; writes the pools in place and
    returns the next tokens [B] (int32).

    ``ctx_lens`` include the token being decoded (it attends to itself
    through the page its K/V row was just written into); inactive slots
    carry ctx 0 and write into the null page. The token is drawn under
    the (seed, position + 1) key: position + 1 is where it will stand."""
    b = tokens.shape[0]
    hidden = params["wte"].shape[1]
    d = hidden // num_heads
    sm = 1.0 / math.sqrt(d)
    x = params["wte"][tokens] + params["wpe"][positions]           # [B, H]
    for li, bp in enumerate(params["blocks"]):
        a = _ln(x, bp["ln1_w"], bp["ln1_b"])
        qkv = a @ bp["qkv_w"] + bp["qkv_b"]                        # [B, 3H]
        q = qkv[:, :hidden].reshape(b, num_heads, d)
        k_pool[li].index_put_((slot_pages, slot_offsets),
                              qkv[:, hidden:2 * hidden].to(k_pool.dtype))
        v_pool[li].index_put_((slot_pages, slot_offsets),
                              qkv[:, 2 * hidden:].to(v_pool.dtype))
        o = ck.paged_attention(q, k_pool[li], v_pool[li], block_tables,
                               ctx_lens, sm_scale=sm)
        x = x + o.reshape(b, hidden) @ bp["out_w"] + bp["out_b"]
        x = _mlp(bp, x)
    logits = _head(params, _ln(x, params["lnf_w"], params["lnf_b"]))
    return sample_tokens(logits, seeds, positions + 1, temps, top_ks, top_ps)


@torch.no_grad()
def verify_step(params, k_pool, v_pool, tokens, positions, block_tables,
                ctx0, slot_pages, slot_offsets, drafts, seeds, temps,
                top_ks, top_ps, num_heads):
    """The speculative verify step: per slot, ``tokens[b] = [last_token,
    draft_0 .. draft_{k-1}]`` at absolute positions L .. L+k, where L is
    the committed KV length and ``ctx0[b] = L + 1`` (0 = inactive). Row
    j's K/V is written into its (page, offset) slot and K1 attends row j
    over ``ctx0 + j`` tokens. Returns (samples [B, k+1] drawn by the
    shared rule at each position, n_acc [B] = the longest draft prefix
    that agrees with them)."""
    b, kp1 = tokens.shape
    hidden = params["wte"].shape[1]
    d = hidden // num_heads
    sm = 1.0 / math.sqrt(d)
    pos_c = positions.clamp(0, params["wpe"].shape[0] - 1)
    x = params["wte"][tokens] + params["wpe"][pos_c]           # [B, k+1, H]
    for li, bp in enumerate(params["blocks"]):
        a = _ln(x, bp["ln1_w"], bp["ln1_b"])
        qkv = a @ bp["qkv_w"] + bp["qkv_b"]
        q = qkv[..., :hidden].reshape(b, kp1, num_heads, d)
        k_pool[li].index_put_((slot_pages, slot_offsets),
                              qkv[..., hidden:2 * hidden].to(k_pool.dtype))
        v_pool[li].index_put_((slot_pages, slot_offsets),
                              qkv[..., 2 * hidden:].to(v_pool.dtype))
        o = ck.paged_attention_verify(q, k_pool[li], v_pool[li],
                                      block_tables, ctx0, sm_scale=sm)
        x = x + o.reshape(b, kp1, hidden) @ bp["out_w"] + bp["out_b"]
        x = _mlp(bp, x)
    logits = _head(params, _ln(x, params["lnf_w"], params["lnf_b"]))
    samples = sample_tokens(
        logits.reshape(b * kp1, -1), seeds.repeat_interleave(kp1),
        (positions + 1).reshape(-1), temps.repeat_interleave(kp1),
        top_ks.repeat_interleave(kp1), top_ps.repeat_interleave(kp1),
    ).reshape(b, kp1)
    # longest draft prefix that agrees with the samples: cumprod zeroes
    # everything past the first mismatch
    match = (samples[:, :-1] == drafts).to(torch.int32)
    n_acc = match.cumprod(dim=1).sum(dim=1)
    return samples, n_acc


@torch.no_grad()
def prefill_step(params, k_pool, v_pool, ids, start, prefix_pages,
                 slot_pages, slot_offsets, seed, temp, top_k, top_p,
                 num_heads):
    """Prefill one prompt's un-cached tail ``ids`` [T] standing at
    positions start .. start+T-1, over ``start`` cached tokens held in
    ``prefix_pages`` (full pages). Dense causal attention in fp32; the
    tail's K/V rows are written into (slot_pages, slot_offsets). Returns
    the first generated token (a [1] int32 tensor), drawn under the key
    position start + T."""
    n = ids.shape[0]
    hidden = params["wte"].shape[1]
    d = hidden // num_heads
    sm = 1.0 / math.sqrt(d)
    dev = ids.device
    q_pos = start + torch.arange(n, device=dev)
    x = params["wte"][ids] + params["wpe"][q_pos]                  # [T, H]
    # query i (absolute position start + i) sees keys 0 .. start + i
    keep = torch.ones(n, start + n, dtype=torch.bool, device=dev) \
        .tril(diagonal=start)[None]
    for li, bp in enumerate(params["blocks"]):
        a = _ln(x, bp["ln1_w"], bp["ln1_b"])
        qkv = a @ bp["qkv_w"] + bp["qkv_b"]                        # [T, 3H]
        q = qkv[:, :hidden].reshape(n, num_heads, d)
        k_new = qkv[:, hidden:2 * hidden]
        v_new = qkv[:, 2 * hidden:]
        k_pool[li].index_put_((slot_pages, slot_offsets),
                              k_new.to(k_pool.dtype))
        v_pool[li].index_put_((slot_pages, slot_offsets),
                              v_new.to(v_pool.dtype))
        kk = k_new.reshape(n, num_heads, d)
        vv = v_new.reshape(n, num_heads, d)
        if start:
            kk = torch.cat([k_pool[li][prefix_pages].reshape(
                start, num_heads, d).to(kk.dtype), kk])
            vv = torch.cat([v_pool[li][prefix_pages].reshape(
                start, num_heads, d).to(vv.dtype), vv])
        s = torch.einsum("qhd,khd->hqk", q.float() * sm, kk.float())
        s = torch.where(keep, s, torch.full_like(s, -1e30))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = torch.where(keep, p, torch.zeros_like(p))
        p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("hqk,khd->qhd", p, vv.float()).to(x.dtype)
        x = x + o.reshape(n, hidden) @ bp["out_w"] + bp["out_b"]
        x = _mlp(bp, x)
    last = _ln(x[n - 1:], params["lnf_w"], params["lnf_b"])        # [1, H]
    one = lambda v, dt: torch.tensor([v], dtype=dt, device=dev)
    return sample_tokens(_head(params, last), one(seed, torch.int64),
                         one(start + n, torch.int64),
                         one(temp, torch.float32), one(top_k, torch.int64),
                         one(top_p, torch.float32))


class ServingEngine:
    """Continuous-batching serving over one model.

    Drive it with ``submit(Request)`` + ``step()`` (one scheduler
    iteration: admissions and prefills, then one decode or verify step
    for the whole batch), or ``run_until_done()``. ``device`` follows the
    port's rule ("cuda" unless ``device="cpu"`` is passed) and must be
    where the model's weights are.
    """

    def __init__(self, model, config=None, device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model's weights are on {model.device}, "
                             f"the engine runs on {self.device}")
        self.device = model.device
        cfg = model.config
        self.model_config = cfg
        self.config = config or ServingConfig()
        c = self.config
        self.num_heads = cfg.num_heads
        self.max_model_len = int(c.max_model_len or cfg.max_seq_len)
        self.page_size = c.page_size
        self.max_pages_per_seq = \
            (self.max_model_len + self.page_size - 1) // self.page_size
        if c.num_pages is None:
            # default pool: every slot can reach max_model_len, + null
            # page + one admission's worth of slack
            c.num_pages = c.max_batch * self.max_pages_per_seq \
                + self.max_pages_per_seq + 1
        self.params = extract_gpt_params(model)
        kv_dtype = c.kv_dtype or self.params["wte"].dtype
        self.cache = PagedKVCache(
            cfg.num_layers, c.num_pages, c.page_size, cfg.num_heads,
            cfg.hidden_size // cfg.num_heads, kv_dtype, device=self.device)
        self.prefix_cache = PrefixCache(self.cache,
                                        enabled=c.prefix_caching)
        self.scheduler = Scheduler(self.cache, self.prefix_cache,
                                   c.max_batch, c.prefill_token_budget,
                                   queue_limit=c.queue_limit)
        # graceful-degradation caps set through ``apply_degradation``;
        # None runs the knob at its configured value
        self.degrade_spec_cap = None
        self.degrade_max_new_cap = None
        self.degraded_submits = 0
        self.steps = 0
        self.decode_steps = 0
        self.speculator = None
        if c.spec_k > 0:
            from .speculator import NGramSpeculator
            self.speculator = NGramSpeculator(k=c.spec_k,
                                              max_ngram=c.spec_ngram)
        self.spec_verify_steps = 0     # per-sequence verify dispatches
        self.spec_accepted_total = 0   # accepted draft tokens
        self.spec_committed_total = 0  # accepted + bonus tokens
        # the step programs: on CUDA their graphs, captured and checked
        # here at init so the first request never pays a capture; on the
        # CPU the eager step functions
        self._staged = {}              # program -> staging buffers
        self.programs = {}             # program -> its manifest
        self.compile_cache = compile_cache.CompileCache(
            c.compile_cache_dir) if c.compile_cache_dir else None
        self._decode = self._adopt("serving/decode_step", 1,
                                   *self.decode_capture_args())
        self._verify = verify_step
        if self.speculator is not None:
            self._verify = self._adopt("serving/verify_step", c.spec_k + 1,
                                       *self.verify_capture_args())

    def _adopt(self, program, kq, fn, args):
        """``program``'s step (``compile_cache.adopt``), its graph checked
        on a live batch of ``kq`` query rows per slot."""
        step, self.programs[program] = compile_cache.adopt(
            fn, args, program, cache=self.compile_cache,
            meta=self.cache_meta(),
            live=lambda: self._stage_check_batch(kq))
        return step

    def _stage_check_batch(self, kq):
        """Stage a live batch into the inputs of the step with ``kq``
        query rows per slot, for the check of its graph
        (``compile_cache.check``): every slot active over pages of its
        own filled with random K/V, at context lengths spread up to the
        model length, greedy and sampled rows mixed. Returns the tensors
        the step writes (the pools) and the function that zeroes the
        pages and frees them again."""
        b, maxp, ps = self.config.max_batch, self.max_pages_per_seq, \
            self.page_size
        k = kq - 1
        g = torch.Generator().manual_seed(0)
        vocab = self.params["wte"].shape[0]
        per_slot = self.cache.free_page_count // b
        rows = {n: [[0] * kq for _ in range(b)] for n in (
            "tokens", "positions", "spages", "soffs")}
        tables = [[0] * maxp for _ in range(b)]
        ctx, seeds, top_ks = [0] * b, [0] * b, [0] * b
        temps, top_ps = [0.0] * b, [1.0] * b
        pages = []
        for i in range(b):
            n = min((i + 1) * (self.max_model_len - kq) // b,
                    per_slot * ps - kq)           # committed tokens
            if n < 0:
                continue                          # no room: inactive
            own = [self.cache.allocate_page()
                   for _ in range(-(-(n + kq) // ps))]
            pages += own
            tables[i][:len(own)] = own
            rows["tokens"][i] = torch.randint(1, vocab, (kq,),
                                              generator=g).tolist()
            rows["positions"][i] = list(range(n, n + kq))
            rows["spages"][i] = [own[(n + j) // ps] for j in range(kq)]
            rows["soffs"][i] = [(n + j) % ps for j in range(kq)]
            ctx[i] = n + 1
            seeds[i] = 1000 + i
            temps[i] = 0.0 if i % 2 == 0 else 0.8
            top_ks[i], top_ps[i] = (20, 0.9) if i % 4 == 3 else (0, 1.0)
        ints = [_flat(rows[n]) for n in ("tokens", "positions")] \
            + [_flat(tables), ctx, _flat(rows["spages"]),
               _flat(rows["soffs"])]
        if k:
            ints.append([t for r in rows["tokens"] for t in r[1:]])
        self._stage("serving/decode_step" if not k
                    else f"serving/verify_step_k{k}",
                    ints + [seeds, top_ks], [temps, top_ps])
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        dev_gen = torch.Generator(self.device).manual_seed(0)
        for pool in (self.cache.k, self.cache.v):
            pool[:, idx] = torch.randn(
                (pool.shape[0], len(pages)) + pool.shape[2:],
                generator=dev_gen, device=self.device).to(pool.dtype)

        def restore():
            for pool in (self.cache.k, self.cache.v):
                pool[:, idx] = 0
            for p in pages:
                self.cache.free_page(p)
        return (self.cache.k, self.cache.v), restore

    def _to_device(self, dtype, *rows):
        """Flat number lists -> 1-D device tensors of ``dtype``, in one
        host-to-device copy."""
        flat = torch.tensor([v for r in rows for v in r], dtype=dtype)
        return list(flat.to(self.device).split([len(r) for r in rows]))

    # -- the step programs' inputs -------------------------------------------
    def _staging(self, program, int_shapes, float_rows):
        """``program``'s input buffers, made on first use: one int32 and
        one fp32 device buffer split into views of ``int_shapes`` and of
        ``float_rows``' (shape, initial value) pairs, each filled from a
        host buffer (pinned on the card). The views are the program's
        inputs, and on CUDA its graph's static inputs."""
        st = self._staged.get(program)
        if st is not None:
            return st
        pin = self.device.type == "cuda"
        bufs, views = [], []
        for dtype, shapes in ((torch.int32, int_shapes),
                              (torch.float32, [sh for sh, _ in float_rows])):
            sizes = [math.prod(sh) for sh in shapes]
            host = torch.zeros(sum(sizes), dtype=dtype, pin_memory=pin)
            dev = torch.zeros_like(host, device=self.device) if pin else host
            bufs.append((host, dev))
            views.append([v.view(sh) for v, sh in
                          zip(dev.split(sizes), shapes)])
        for v, (_, init) in zip(views[1], float_rows):
            v.fill_(init)
        bufs[1][0].copy_(bufs[1][1])
        st = self._staged[program] = (bufs, views)
        return st

    def _stage(self, program, int_rows, float_rows):
        """Write the step's flat host rows into ``program``'s staging
        buffers: one host write and one copy to the device per dtype."""
        bufs, _ = self._staged[program]
        for (host, dev), rows in zip(bufs, (int_rows, float_rows)):
            host.numpy()[:] = [v for r in rows for v in r]
            if dev is not host:
                dev.copy_(host, non_blocking=True)

    def cache_meta(self):
        """The model config the compile cache's manifests record."""
        cfg = self.model_config
        return {"model": {k: getattr(cfg, k) for k in (
            "vocab_size", "hidden_size", "num_layers", "num_heads",
            "intermediate_size", "max_seq_len", "use_rmsnorm",
            "tie_word_embeddings")}}

    def decode_capture_args(self):
        """(step function, arguments) of the decode step at this
        engine's fixed shapes: batch max_batch, one query row per slot.
        The per-step inputs are the staging views, all slots inactive."""
        b, maxp = self.config.max_batch, self.max_pages_per_seq
        _, (vi, vf) = self._staging(
            "serving/decode_step",
            [(b,), (b,), (b, maxp), (b,), (b,), (b,), (b,), (b,)],
            [((b,), 0.0), ((b,), 1.0)])
        tokens, positions, tables, ctx, spages, soffs, seeds, top_ks = vi
        temps, top_ps = vf
        return decode_step, (
            self.params, self.cache.k, self.cache.v, tokens, positions,
            tables, ctx, spages, soffs, seeds, temps, top_ks, top_ps,
            self.num_heads)

    def verify_capture_args(self, spec_k=None):
        """(step function, arguments) of the speculative verify step at
        this engine's fixed shapes: batch max_batch, k + 1 query rows per
        slot."""
        k = int(spec_k if spec_k is not None else self.config.spec_k)
        if k < 1:
            raise ValueError("verify capture needs spec_k >= 1")
        b, maxp, kp1 = self.config.max_batch, self.max_pages_per_seq, k + 1
        _, (vi, vf) = self._staging(
            f"serving/verify_step_k{k}",
            [(b, kp1), (b, kp1), (b, maxp), (b,), (b, kp1), (b, kp1),
             (b, k), (b,), (b,)],
            [((b,), 0.0), ((b,), 1.0)])
        tokens, positions, tables, ctx0, spages, soffs, drafts, seeds, \
            top_ks = vi
        temps, top_ps = vf
        return verify_step, (
            self.params, self.cache.k, self.cache.v, tokens, positions,
            tables, ctx0, spages, soffs, drafts, seeds, temps, top_ks,
            top_ps, self.num_heads)

    # -- request side --------------------------------------------------------
    def submit(self, request):
        if len(request.prompt_tokens) >= self.max_model_len:
            raise ValueError(
                f"prompt of {len(request.prompt_tokens)} tokens leaves "
                f"no room to generate under max_model_len="
                f"{self.max_model_len}")
        if len(request.prompt_tokens) + request.max_new_tokens \
                > self.max_model_len:
            request.max_new_tokens = \
                self.max_model_len - len(request.prompt_tokens)
        # a sequence whose full context cannot fit the pool would never
        # admit (or would evict forever): reject at submit
        total = len(request.prompt_tokens) + request.max_new_tokens
        need = (total + self.page_size - 1) // self.page_size
        usable = self.cache.num_pages - 1
        if need > usable:
            raise RequestTooLarge(
                f"request needs {need} KV pages for {total} tokens but "
                f"the pool has {usable} usable pages — raise "
                f"num_pages/PADDLE_SERVE_NUM_PAGES or shorten the "
                f"request")
        if self.degrade_max_new_cap is not None \
                and request.max_new_tokens > self.degrade_max_new_cap:
            request.max_new_tokens = int(self.degrade_max_new_cap)
            self.degraded_submits += 1
        self.scheduler.submit(request)

    def apply_degradation(self, spec_cap=None, prefill_budget_cap=None,
                          max_new_cap=None):
        """Apply (or, with None, release) the brownout caps. Fully
        reversible: the configured values stay in ``self.config``;
        running sequences are never touched."""
        self.degrade_spec_cap = None if spec_cap is None else int(spec_cap)
        base = self.config.prefill_token_budget
        self.scheduler.prefill_token_budget = base \
            if prefill_budget_cap is None else min(base,
                                                   int(prefill_budget_cap))
        self.degrade_max_new_cap = None if max_new_cap is None \
            else int(max_new_cap)

    def has_work(self):
        return self.scheduler.has_work()

    # -- the engine step -----------------------------------------------------
    def step(self):
        with trace.span("serve.step", step=self.steps):
            self._admit()
            if self.scheduler.running:
                if self.speculator is not None:
                    self._verify_step()
                else:
                    self._decode_step()
            SERVE_OCCUPANCY.set(self.scheduler.occupancy)
            SERVE_FREE_PAGES.set(self.cache.free_page_count)
        self.steps += 1

    def run_until_done(self, max_steps=100000):
        for _ in range(max_steps):
            if not self.has_work():
                return self.scheduler.finished
            self.step()
        raise RuntimeError("serving did not drain within max_steps")

    # -- admission / prefill -------------------------------------------------
    def _admit(self):
        plans = self.scheduler.plan_admissions()
        if not plans:
            return
        with trace.span("serve.admit", n=len(plans)):
            for seq, _keys, _pages in plans:
                self._prefill(seq)

    def _prefill(self, seq):
        req = seq.request
        ps = self.page_size
        SERVE_PREFIX_LOOKUPS.inc()
        # re-lookup at prefill time: pages are published as soon as a
        # prompt is prefilled, so a same-step follower sharing the system
        # prompt hits pages its admission-time lookup could not see yet
        keys, pages = self.prefix_cache.lookup(req.prompt_tokens)
        max_adopt = (len(req.prompt_tokens) - 1) // ps
        keys, pages = keys[:max_adopt], pages[:max_adopt]
        if pages:
            # an earlier admission's allocations may have reclaimed LRU
            # pages since the plan
            keys, pages = self.prefix_cache.try_acquire(keys, pages)
        if pages:
            seq.table.adopt_shared(pages)
            req.prefix_hit_tokens = len(pages) * ps
            SERVE_PREFIX_HITS.inc()
            SERVE_PREFIX_TOKENS_SKIPPED.inc(req.prefix_hit_tokens)
        start = seq.table.length
        tail = req.prompt_tokens[start:]
        slot_pages, slot_offs = seq.table.append_slots(len(tail))
        ids, prefix, spages, soffs = self._to_device(
            torch.int32, tail, pages, slot_pages, slot_offs)
        with trace.span("serve.prefill", rid=req.rid, request=req.id,
                        tokens=len(tail), cached_tokens=len(pages) * ps):
            nxt = prefill_step(
                self.params, self.cache.k, self.cache.v, ids, start,
                prefix, spages, soffs, req.seed, req.temperature,
                req.top_k, req.top_p, self.num_heads)
            first = nxt.tolist()[0]
        SERVE_PREFILL_TOKENS.inc(len(tail))
        SERVE_TOKENS.inc()
        # publish the prompt's full pages now: they are filled and
        # immutable from here on
        self.prefix_cache.publish(req.prompt_tokens, seq.table)
        self.scheduler.bind(seq, first)
        if req.ttft_s is not None:
            SERVE_TTFT_MS.observe(req.ttft_s * 1e3)
        if req.max_new_tokens <= 1 or (
                req.eos_token_id is not None
                and first == int(req.eos_token_id)):
            self.scheduler.finish(seq)

    # -- decode --------------------------------------------------------------
    @staticmethod
    def _sampling_row(req):
        return (int(req.seed), float(req.temperature), int(req.top_k),
                float(req.top_p))

    def _decode_step(self):
        slots = self.scheduler.ensure_decode_capacity()
        if not slots:
            return
        b = self.config.max_batch
        maxp = self.max_pages_per_seq
        tokens, positions, ctx = [0] * b, [0] * b, [0] * b
        tables = [[0] * maxp for _ in range(b)]
        spages, soffs = [0] * b, [0] * b
        seeds, top_ks = [0] * b, [0] * b
        temps, top_ps = [0.0] * b, [1.0] * b
        active = []
        for seq, base, pages, offs in slots:
            i = seq.slot
            tokens[i] = seq.last_token
            positions[i] = base                      # 0-based next pos
            tables[i] = seq.table.padded(maxp)
            ctx[i] = seq.table.length                # incl. this token
            spages[i] = pages[0]
            soffs[i] = offs[0]
            seeds[i], temps[i], top_ks[i], top_ps[i] = \
                self._sampling_row(seq.request)
            active.append(seq)
        _, args = self.decode_capture_args()
        self._stage("serving/decode_step",
                    [tokens, positions, _flat(tables), ctx, spages, soffs,
                     seeds, top_ks], [temps, top_ps])
        with trace.span("serve.decode_step", occupancy=len(active),
                        batch=b, rids=[s.request.rid for s in active]):
            nxt = self._decode(*args)
            out = nxt.tolist()          # the step's one host transfer
        self.decode_steps += 1
        for seq in active:
            SERVE_TOKENS.inc()
            req = seq.request
            self.scheduler.advance(seq, out[seq.slot])
            if req.state == "finished" and req.tpot_s is not None:
                SERVE_TPOT_MS.observe(req.tpot_s * 1e3)

    # -- speculative decode --------------------------------------------------
    def _spec_cap(self, seq):
        """How many draft tokens this sequence may verify this step: the
        step commits up to cap + 1 tokens, so cap is bounded by the
        remaining generation budget and by the model length."""
        req = seq.request
        remaining = req.max_new_tokens - len(req.output_tokens)
        room = self.max_model_len - 1 - seq.table.length
        k = self.config.spec_k
        if self.degrade_spec_cap is not None:
            k = min(k, self.degrade_spec_cap)
        return max(0, min(k, remaining - 1, room))

    def _verify_step(self):
        """One speculative step: draft host-side (n-gram lookup over each
        sequence's committed tokens), verify every sequence's k + 1
        positions in one pass, commit the accepted prefix + bonus token,
        and roll rejected KV back by block-table truncation."""
        k = self.config.spec_k
        kp1 = k + 1
        slots = self.scheduler.ensure_decode_capacity(
            n_for=lambda s: self._spec_cap(s) + 1)
        if not slots:
            return
        b = self.config.max_batch
        maxp = self.max_pages_per_seq
        tokens = [[0] * kp1 for _ in range(b)]
        positions = [[0] * kp1 for _ in range(b)]
        tables = [[0] * maxp for _ in range(b)]
        ctx0 = [0] * b
        spages = [[0] * kp1 for _ in range(b)]
        soffs = [[0] * kp1 for _ in range(b)]
        drafts = [[0] * k for _ in range(b)]
        seeds, top_ks = [0] * b, [0] * b
        temps, top_ps = [0.0] * b, [1.0] * b
        caps, bases, active = {}, {}, []
        for seq, base, pages, offs in slots:
            i = seq.slot
            cap = len(pages) - 1       # rows actually backed by slots
            caps[i] = cap
            bases[i] = base
            req = seq.request
            dr = []
            if cap > 0:
                dr = self.speculator.propose(
                    req.prompt_tokens + req.output_tokens, cap)[:cap]
            # pad drafts with 0: an accidentally accepted pad commits the
            # SAMPLE (the right token by construction)
            tokens[i] = [seq.last_token] + dr + [0] * (k - len(dr))
            positions[i] = [base + j for j in range(kp1)]
            tables[i] = seq.table.padded(maxp)
            ctx0[i] = base + 1
            # rows past the reservation write into the null page
            spages[i] = pages + [0] * (kp1 - len(pages))
            soffs[i] = offs + [0] * (kp1 - len(offs))
            drafts[i] = dr + [0] * (k - len(dr))
            seeds[i], temps[i], top_ks[i], top_ps[i] = \
                self._sampling_row(req)
            active.append(seq)
        _, args = self.verify_capture_args()
        self._stage(f"serving/verify_step_k{k}",
                    [_flat(tokens), _flat(positions), _flat(tables), ctx0,
                     _flat(spages), _flat(soffs), _flat(drafts), seeds,
                     top_ks], [temps, top_ps])
        with trace.span("serve.verify_step", occupancy=len(active),
                        batch=b, spec_k=k,
                        rids=[s.request.rid for s in active]):
            samples, n_acc = self._verify(*args)
            # one transfer for both results
            both = torch.cat([samples, n_acc[:, None].to(samples.dtype)],
                             dim=1).tolist()
        self.decode_steps += 1
        for seq in active:
            i = seq.slot
            req = seq.request
            # acceptance capped at the row budget: matches past cap are
            # pad artifacts the KV reservation cannot back
            m = min(both[i][kp1], caps[i])
            commit = both[i][:m + 1]        # accepted prefix + bonus
            if req.eos_token_id is not None:
                eos = int(req.eos_token_id)
                if eos in commit:
                    commit = commit[:commit.index(eos) + 1]
            m_eff = len(commit) - 1
            # rollback: the committed state is base + 1 + m_eff rows (the
            # bonus token's KV rides the next step, as in plain decode)
            freed = seq.table.truncate(bases[i] + 1 + m_eff)
            if freed:
                SERVE_SPEC_ROLLBACK_PAGES.inc(freed)
            self.spec_verify_steps += 1
            self.spec_accepted_total += m_eff
            self.spec_committed_total += len(commit)
            SERVE_SPEC_STEPS.inc()
            if m_eff:
                SERVE_SPEC_ACCEPTED.inc(m_eff)
            for t in commit:
                SERVE_TOKENS.inc()
                if not self.scheduler.advance(seq, t):
                    break
            if req.state == "finished" and req.tpot_s is not None:
                SERVE_TPOT_MS.observe(req.tpot_s * 1e3)


def serve(model, requests, config=None, device=None):
    """One-call serving: run ``requests`` (Request objects or
    (prompt_tokens, max_new_tokens) pairs) through a fresh engine under
    continuous batching; returns the finished Requests in completion
    order."""
    eng = ServingEngine(model, config, device=device)
    for r in requests:
        if not isinstance(r, Request):
            r = Request(r[0], max_new_tokens=r[1])
        eng.submit(r)
    return eng.run_until_done()
