"""Next-token sampling for the serving engine (counterpart:
``paddle_tpu/inference/serving/sampling.py``).

One rule, ``sample_tokens``, serves the prefill, decode and verify steps,
so the three cannot drift. Temperature <= 0 is greedy argmax. Otherwise
the logits pass through ``filter_logits`` (temperature, top-k, top-p;
the same arithmetic as the JAX package, so it matches it exactly) and a
Gumbel-max draw picks the token.

The contract the JAX package keeps is kept here: a draw is a pure
function of (seed, position, logits), never of batch composition or of
whether the position was reached speculatively. That is what makes
speculative decoding lossless: the verify step recomputes the draw at
k + 1 positions and accepts the draft prefix that agrees with it. The
JAX package keys its draw with ``fold_in(PRNGKey(seed), position)``,
which torch cannot reproduce; here the Gumbel noise for vocabulary entry
i comes from a stateless integer hash of (seed, position, i) computed
with torch integer ops on the logits' device. The same (seed, position)
therefore draws the same token on any device, but not the token the JAX
package draws: sampled outputs agree with it in distribution only.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mix32(x):
    """The lowbias32 integer finalizer on int64 tensors holding 32-bit
    values (products are masked back to 32 bits)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def token_uniforms(seeds, positions, vocab_size):
    """[N, V] uniforms in (0, 1): entry (n, i) is a pure function of
    (seeds[n], positions[n], i)."""
    dev = seeds.device
    key = _mix32(_mix32(seeds.long() & _M32) ^ (positions.long() & _M32))
    idx = torch.arange(vocab_size, device=dev, dtype=torch.int64)
    bits = _mix32(key[:, None] ^ _mix32((idx + 0x9E3779B9) & _M32)[None, :])
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def filter_logits(logits, temps, top_ks, top_ps):
    """Temperature / top-k / top-p filtering with per-row knobs.
    ``logits`` [N, V]; ``temps`` [N] (the greedy case is the caller's),
    ``top_ks`` [N] (0 = off), ``top_ps`` [N] (1.0 = off). Returns fp32
    logits with the filtered entries at -inf."""
    v = logits.shape[-1]
    lg = logits.float() / temps.float().clamp_min(1e-6)[:, None]
    srt = torch.sort(lg, dim=-1, descending=True).values
    kth_idx = top_ks.long().clamp(1, v) - 1
    kth = srt.gather(-1, kth_idx[:, None])
    # a fill, not a host-to-device copy: this runs inside captured graphs
    neg_inf = lg.new_full((), float("-inf"))
    lg = torch.where((top_ks > 0)[:, None] & (lg < kth), neg_inf, lg)
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_idx = (cum < top_ps.float()[:, None]).sum(dim=-1) \
        .clamp_max(v - 1)
    pth = srt.gather(-1, cutoff_idx[:, None])
    return torch.where((top_ps < 1.0)[:, None] & (lg < pth), neg_inf, lg)


def sample_tokens(logits, seeds, positions, temps, top_ks, top_ps):
    """The shared next-token rule. ``logits`` [N, V]; per-row ``seeds``,
    ``positions`` (the absolute position the token will occupy),
    ``temps``, ``top_ks``, ``top_ps`` [N]. Returns int32 tokens [N]."""
    greedy = logits.argmax(dim=-1)
    filtered = filter_logits(logits, temps, top_ks, top_ps)
    u = token_uniforms(seeds, positions, logits.shape[-1])
    sampled = (filtered - torch.log(-torch.log(u))).argmax(dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def speculative_accept(key, p_logits, q_probs, draft_token):
    """Textbook speculative-sampling acceptance for one position with a
    general draft distribution q: accept ``draft_token`` (drawn from q)
    with probability min(1, p/q), else resample from the residual
    norm(max(p - q, 0)). Returns (accepted bool tensor, committed int32
    token). The committed token is distributed exactly as p whatever q
    is. ``key`` is a (seed, position) pair: as every draw here, both
    uniforms are pure functions of it (the accept uniform from the pair,
    the residual draw from the pair with its seed re-mixed), where the
    reference splits a PRNG key. The serving engine's n-gram draft is the
    point-mass case, which ``sample_tokens``' recompute-and-compare
    covers."""
    seed, pos = (int(x) for x in key)
    dev = p_logits.device
    v = p_logits.shape[-1]
    u = token_uniforms(torch.tensor([seed, seed ^ 0x5BD1E995], device=dev),
                       torch.tensor([pos, pos], device=dev), v)
    p = torch.softmax(p_logits.float(), dim=-1)
    q = q_probs.float()
    ratio = p[draft_token] / q[draft_token].clamp_min(1e-30)
    accepted = u[0, 0] < ratio.clamp_max(1.0)
    resid = (p - q).clamp_min(0.0)
    resid = resid / resid.sum().clamp_min(1e-30)
    resampled = (torch.log(resid + 1e-38) - torch.log(-torch.log(u[1]))) \
        .argmax()
    token = torch.where(accepted, torch.as_tensor(draft_token, device=dev),
                        resampled).to(torch.int32)
    return accepted, token
