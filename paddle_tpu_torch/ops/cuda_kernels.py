"""The port's hand-written Hopper kernels, their gates, wrappers and
plain PyTorch versions.

Counterpart: ``paddle_tpu/ops/pallas_kernels.py``. All five of its TPU
kernels are ported here:

- K1 ``_paged_verify_kernel`` -> ``csrc/paged_attention.cu``
  (``paged_attention*``): ragged paged attention for decode (one query
  row per slot) and speculative verify (k + 1 rows per slot);
- K2 ``_fwd_kernel`` -> ``csrc/flash_fwd.cu`` (``flash_attention*``):
  the flash-attention forward, returning o and the natural-log lse;
- K3 ``_bwd_fused_kernel`` -> ``csrc/flash_bwd.cu``
  (``flash_attention_bwd``): the flash-attention backward, dq and dk/dv
  from the saved q, k, v, o and lse. K2 and K3 are the forward and
  backward of one differentiable ``torch.library`` op
  (``paddle_tpu_torch::flash_fwd``, its backward
  ``paddle_tpu_torch::flash_bwd``), the counterpart of the JAX package's
  custom-vjp ``_flash_core_lse``; each has a fake from shapes alone, so a
  ``torch.export`` capture (``jit``) and a static placeholder
  (``static``) record it as one node;
- K4 ``_vl_fwd_kernel`` -> ``csrc/flash_varlen_fwd.cu`` and K5
  ``_vl_bwd_kernel`` -> ``csrc/flash_varlen_bwd.cu``
  (``flash_attention_varlen*``): packed varlen attention over
  block-diagonal segments, forward and backward of
  ``FlashAttentionVarlen``, the counterpart of ``_flash_varlen_core``.

Each kernel sits beside its plain PyTorch version (``*_reference``),
which the CPU tests and ``chip_smoke.py`` hold the kernel against. A
wrapper takes the plain version only when every tensor it was given lies
on the CPU; on CUDA tensors it launches the kernel or raises, and never
falls back. Each launch adds one to the kernel's ``launches`` count;
a launch that a CUDA-graph capture records on this thread goes to the
capture's tally instead (``recording_launches``), and each replay of
the graph adds the tally to the counts.

K1, K4 and K5 stay ctypes calls on data pointers: a capture that reaches
one of them raises (``_refuse_capture``), naming ROADMAP A10.

The gates (``*_available``) keep the JAX package's shape contract, minus
its TPU-only backend check and its 512-token floor; they decide by shape
alone, never by whether a kernel built.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading
import weakref
from typing import NamedTuple

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("fp32", "bf16", "fp16")   # the route of each dtype code
_MAX_SMEM = 232448   # bytes of shared memory one H100 block can use
_RECORDING = threading.local()   # .tally: this thread's capture's tally


class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times a wrapper launched it, in all (``launches``) and by route
    (``route_launches``: the fp32 scalar route, the bf16 and the fp16
    16-bit routes; every C entry takes its dtype code last)."""

    def __init__(self, name, entry, argtypes, replaces):
        self.name = name
        self.source = f"paddle_tpu_torch/csrc/{name}.cu"
        self.replaces = replaces
        self._entry = entry
        self._argtypes = argtypes
        self._fn = None
        self.route_launches = dict.fromkeys(ROUTES, 0)

    @property
    def launches(self):
        return sum(self.route_launches.values())

    def entry(self):
        """The C entry point, built and loaded on first use."""
        if self._fn is None:
            fn = getattr(_build.load(self.name), self._entry)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device, *args):
        """Call the entry on ``device``'s current stream; raise when the
        launch reports a CUDA error."""
        fn = self.entry()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed with CUDA "
                               f"error {rc}")
        tally = getattr(_RECORDING, "tally", None)
        counts = self.route_launches if tally is None else \
            tally.setdefault(self.name, dict.fromkeys(ROUTES, 0))
        counts[ROUTES[args[-1]]] += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_L = ctypes.c_longlong

PAGED_ATTENTION = Kernel(
    "paged_attention", "paged_attention_fwd",
    [_P] * 7 + [_I] * 6 + [_L, _L, _I, _F, _I, _P],
    "paddle_tpu/ops/pallas_kernels.py:1167")
FLASH_FWD = Kernel(
    "flash_fwd", "flash_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "paddle_tpu/ops/pallas_kernels.py:195")
FLASH_BWD = Kernel(
    "flash_bwd", "flash_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
     _P],
    "paddle_tpu/ops/pallas_kernels.py:398")
FLASH_VARLEN_FWD = Kernel(
    "flash_varlen_fwd", "flash_varlen_fwd",
    [_P] * 10 + [_I, _I, _I, _I, _F, _I, _I, _P],
    "paddle_tpu/ops/pallas_kernels.py:714")
FLASH_VARLEN_BWD = Kernel(
    "flash_varlen_bwd", "flash_varlen_bwd",
    [_P] * 17 + [_I, _I, _I, _I, _I, _F, _I, _I, _P],
    "paddle_tpu/ops/pallas_kernels.py:769")
KERNELS = (PAGED_ATTENTION, FLASH_FWD, FLASH_BWD, FLASH_VARLEN_FWD,
           FLASH_VARLEN_BWD)


def build_kernels():
    """Build every kernel's library now, one ``nvcc`` per source, all in
    parallel. Returns {name: (seconds, compiler output)}."""
    return _build.build([k.name for k in KERNELS])


def reset_launch_counts():
    for k in KERNELS:
        k.route_launches = dict.fromkeys(ROUTES, 0)


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's launches go to the yielded tally,
    ``{kernel name: {route: n}}``, not to the counts: a CUDA-graph capture
    records its kernels and runs none. Other threads count as before."""
    prev = getattr(_RECORDING, "tally", None)
    _RECORDING.tally = tally = {}
    try:
        yield tally
    finally:
        _RECORDING.tally = prev


def add_launches(tally):
    """Add a ``recording_launches`` tally to the counts (one replay of
    the graph it was recorded for)."""
    by_name = {k.name: k for k in KERNELS}
    for name, routes in tally.items():
        for route, n in routes.items():
            by_name[name].route_launches[route] += n


def _on_cpu(*tensors):
    """True when every tensor lies on the CPU, False when every one is on
    the same CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _captured(t):
    """True for a tensor that a graph capture holds in place of data: a
    fake tensor (``torch.export``), a meta tensor, a static placeholder."""
    from torch._subclasses.fake_tensor import is_fake
    return getattr(t, "_is_static_var", False) or t.device.type == "meta" \
        or is_fake(t)


def _refuse_capture(kernel, *tensors):
    """Raise when a graph capture reaches ``kernel``, a ctypes call that a
    capture cannot record (it would quietly trace the plain version)."""
    if any(_captured(t) for t in tensors):
        raise RuntimeError(
            f"{kernel} cannot be captured into a graph (jit.to_static, "
            "jit.save, paddle.static): it is a ctypes call on data pointers, "
            "not yet a torch.library op (ROADMAP A10); run it eagerly")


def _kernel_dtype(*tensors):
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32, bfloat16 or float16, all "
                        f"alike; got {sorted(map(str, dtypes))}")
    return _DTYPE_CODE[dtypes.pop()]


def _need_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _need_aligned(**tensors):
    """The 16-bit routes load and store 16 bytes at a time."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the 16-bit kernel")


# -- K1: ragged paged attention ----------------------------------------------
# Layout contract (the pool the serving engine writes into):
#   q            [B, KQ, h, d]  (decode: [B, h, d], KQ = 1)
#   k/v pages    [num_pages, page_size, h*d]   page 0 is the null page
#   block_tables [B, max_pages] int32, padded with page 0
#   context_lens [B] int32: tokens query row 0 sees (incl. itself);
#                0 = inactive slot -> exact zeros
# Query row j of a slot sees context_lens[b] + j tokens.

def _paged_shapes_ok(b, h, d, k_pages, v_pages, block_tables,
                     context_lens):
    if d not in (64, 128, 256):
        return False
    for pages in (k_pages, v_pages):
        if getattr(pages, "ndim", 0) != 3:
            return False
        if pages.shape[2] != h * d or pages.shape[1] % 16 != 0:
            return False
    if k_pages.shape != v_pages.shape:
        return False
    if getattr(block_tables, "ndim", 0) != 2 or block_tables.shape[0] != b:
        return False
    return getattr(context_lens, "ndim", 0) == 1 and \
        context_lens.shape[0] == b


def paged_attention_available(q, k_pages, v_pages, block_tables,
                              context_lens):
    """Shape gate for paged decode attention: [B, h, d] queries with d in
    (64, 128, 256), pools [num_pages, page_size, h*d] with page_size a
    multiple of 16 (kv heads == q heads), a [B, max_pages] table and [B]
    context lengths."""
    if getattr(q, "ndim", 0) != 3:
        return False
    return _paged_shapes_ok(*q.shape, k_pages, v_pages, block_tables,
                            context_lens)


def paged_attention_verify_available(q, k_pages, v_pages, block_tables,
                                     context_lens):
    """Gate for the k-query verify: [B, KQ, h, d] queries, KQ >= 1, with
    the decode gate's pool and table constraints."""
    if getattr(q, "ndim", 0) != 4 or q.shape[1] < 1:
        return False
    b, _, h, d = q.shape
    return _paged_shapes_ok(b, h, d, k_pages, v_pages, block_tables,
                            context_lens)


def paged_attention_verify_reference(q, k_pages, v_pages, block_tables,
                                     context_lens, sm_scale=None):
    """Plain PyTorch version of K1 (follows the JAX package's
    ``paged_attention_verify_reference``): gather every slot's pages into
    a dense [B, T, h, d] view, masked softmax in fp32, rows of inactive
    slots exactly zero."""
    b, kq, h, d = q.shape
    page_size = k_pages.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    t = bt.shape[1] * page_size
    k = k_pages[bt].reshape(b, t, h, d).float()
    v = v_pages[bt].reshape(b, t, h, d).float()
    ctx = context_lens.long()
    rows = torch.arange(kq, device=q.device)
    lens = torch.where(ctx[:, None] > 0, ctx[:, None] + rows[None, :], 0)
    pos = torch.arange(t, device=q.device)
    mask = (pos[None, None, :] < lens[:, :, None])[:, :, None, :]
    s = torch.einsum("bqhd,bthd->bqht", q.float() * sm_scale, k)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros_like(p))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqht,bthd->bqhd", p, v)
    # rows of inactive slots are +0 exactly (a product with 0 could be -0)
    o = torch.where((lens > 0)[:, :, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


def paged_attention_reference(q, k_pages, v_pages, block_tables,
                              context_lens, sm_scale=None):
    """Plain PyTorch version of K1 for one query row per slot ([B, h, d])."""
    return paged_attention_verify_reference(
        q[:, None], k_pages, v_pages, block_tables, context_lens,
        sm_scale)[:, 0]


_LOG2E = 1.4426950408889634
_SPLIT_TOKENS = 256   # the 16-bit K1's tokens per split (whole pages)


def paged_splits(max_pages, page_size):
    """(pages per split, number of splits) of the 16-bit K1 for a table of
    ``max_pages`` pages: whole pages adding up to about 256 tokens (16
    pages of 16), and as many splits as cover the table's extent. Shapes
    alone decide; no context length is read."""
    split_pages = max(1, _SPLIT_TOKENS // page_size)
    return split_pages, max(1, -(-max_pages // split_pages))


def paged_attention_split_reference(q, k_pages, v_pages, block_tables,
                                    context_lens, sm_scale=None):
    """Plain PyTorch version of the 16-bit K1's split-and-combine: per split
    of ``paged_splits`` pages, (m, l, acc) in fp32 from scores in log2
    units (q scaled by sm_scale * log2(e)), then the splits merged in
    split order. A row with no visible token (an inactive slot) is +0."""
    b, kq, h, d = q.shape
    page_size = k_pages.shape[1]
    max_pages = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    split_pages, n_split = paged_splits(max_pages, page_size)
    extent = max_pages * page_size
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, extent, h, d).float()
    v = v_pages[bt].reshape(b, extent, h, d).float()
    rows = torch.arange(kq, device=q.device)
    ctx = context_lens.long()[:, None]
    n_vis = torch.where(ctx > 0, (ctx + rows).clamp(max=extent), 0)
    s = torch.einsum("bqhd,bthd->bqht", q.float() * (sm_scale * _LOG2E), k)
    pos = torch.arange(extent, device=q.device)
    s = s.masked_fill(pos >= n_vis[:, :, None, None], float("-inf"))
    parts = []
    for i in range(n_split):
        cols = slice(i * split_pages * page_size,
                     (i + 1) * split_pages * page_size)
        m = s[..., cols].amax(-1).clamp(min=-1e30)          # [b, kq, h]
        p = torch.exp2(s[..., cols] - m[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bqht,bthd->bqhd", p, v[:, cols])))
    mx = torch.full_like(parts[0][0], -1e30)
    for m, l, _ in parts:
        mx = torch.where(l > 0, torch.maximum(mx, m), mx)
    total = torch.zeros_like(mx)
    o = torch.zeros(b, kq, h, d, device=q.device)
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp2(m - mx), 0.0)
        total = total + l * w
        o = o + acc * w[..., None]
    o = torch.where(total[..., None] > 0,
                    o / total.clamp(min=1e-30)[..., None], 0.0)
    return o.to(q.dtype)


def _paged_smem(kq, d):
    """Shared memory of the fp32 K1 block in bytes: q and acc rows, 32-token
    K and V tiles, probabilities and three per-row statistics, all fp32.
    (The 16-bit route's footprint does not grow with KQ; the source checks it
    at compile time.)"""
    return 4 * (2 * kq * d + 2 * 32 * d + kq * 32 + 3 * kq)


def _paged_q(q, wide_loads):
    """q as K1 reads it, with its slot and row strides in elements (0 where
    the dimension has one entry). The kernel reads q in place (the serving
    engine's column slice of the packed qkv) when its head stride is d, its
    last stride 1 and, for the 16-bit routes (``wide_loads``), it starts on
    a 16-byte boundary with slot and row strides that are multiples of 8;
    any other q is copied into a fresh contiguous tensor first."""
    b, kq, h, d = q.shape
    sb, sj = (q.stride(0) if b > 1 else 0), (q.stride(1) if kq > 1 else 0)
    fits = q.stride(3) == 1 and (h == 1 or q.stride(2) == d)
    if wide_loads:
        fits = fits and q.data_ptr() % 16 == 0 and sb % 8 == 0 \
            and sj % 8 == 0
    if fits:
        return q, sb, sj
    q = q.clone(memory_format=torch.contiguous_format)
    return q, (kq * h * d if b > 1 else 0), (h * d if kq > 1 else 0)


def paged_attention_verify_decode(q, k_pages, v_pages, block_tables,
                                  context_lens, sm_scale=None):
    """K1 on [B, KQ, h, d] queries: query row j of slot b attends over
    ``context_lens[b] + j`` tokens. On CUDA tensors this launches
    ``csrc/paged_attention.cu``: bf16 and fp16 on its split-context route
    (a split kernel over ``paged_splits`` runs of pages into an fp32
    workspace, then a combine kernel), fp32 on its scalar route. q is read
    in place where its layout allows (``_paged_q``), else copied; 16-bit
    pools must start on a 16-byte boundary. On CPU tensors it runs the
    plain version."""
    _refuse_capture("K1 (paged attention)", q, k_pages, v_pages,
                    block_tables, context_lens)
    b, kq, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if _on_cpu(q, k_pages, v_pages, block_tables, context_lens):
        return paged_attention_verify_reference(
            q, k_pages, v_pages, block_tables, context_lens, sm_scale)
    if not paged_attention_verify_available(q, k_pages, v_pages,
                                            block_tables, context_lens):
        raise ValueError("paged attention kernel does not take these shapes "
                         f"(q {tuple(q.shape)}, pages {tuple(k_pages.shape)}, "
                         f"tables {tuple(block_tables.shape)}, lens "
                         f"{tuple(context_lens.shape)})")
    dtype = _kernel_dtype(q, k_pages, v_pages)
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    _need_contiguous(k_pages=k_pages, v_pages=v_pages,
                     block_tables=block_tables, context_lens=context_lens)
    split_route = dtype != _DTYPE_CODE[torch.float32]
    q, q_sb, q_sj = _paged_q(q, split_route)
    page_size, max_pages = k_pages.shape[1], block_tables.shape[1]
    split_pages, n_split = paged_splits(max_pages, page_size)
    if split_route:
        _need_aligned(k_pages=k_pages, v_pages=v_pages)
        # per split and (slot, row, head): acc [d], then (m, l)
        workspace = torch.empty(n_split * b * kq * h * (d + 2),
                                dtype=torch.float32, device=q.device)
    else:
        smem = _paged_smem(kq, d)
        if smem > _MAX_SMEM:
            raise ValueError(f"KQ={kq} at d={d} needs {smem} bytes of "
                             f"shared memory, more than a block has")
        workspace = q.new_empty(0)
    out = torch.empty((b, kq, h, d), dtype=q.dtype, device=q.device)
    PAGED_ATTENTION.launch(
        q.device, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        workspace.data_ptr(), b, kq, h, d, page_size, max_pages, q_sb, q_sj,
        split_pages, float(sm_scale), dtype)
    return out


def paged_attention_decode(q, k_pages, v_pages, block_tables, context_lens,
                           sm_scale=None):
    """K1 on [B, h, d] queries: the KQ == 1 case of the verify kernel."""
    b, h, d = q.shape
    return paged_attention_verify_decode(
        q.reshape(b, 1, h, d), k_pages, v_pages, block_tables,
        context_lens, sm_scale).reshape(b, h, d)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    sm_scale=None):
    """Route: K1 when the gate admits the shapes, else the dense plain
    version (as the JAX package routes)."""
    if paged_attention_available(q, k_pages, v_pages, block_tables,
                                 context_lens):
        return paged_attention_decode(q, k_pages, v_pages, block_tables,
                                      context_lens, sm_scale)
    return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                     context_lens, sm_scale)


def paged_attention_verify(q, k_pages, v_pages, block_tables, context_lens,
                           sm_scale=None):
    """Route for the k-query verify: K1 when the gate admits the shapes,
    else the dense plain version."""
    if paged_attention_verify_available(q, k_pages, v_pages, block_tables,
                                        context_lens):
        return paged_attention_verify_decode(
            q, k_pages, v_pages, block_tables, context_lens, sm_scale)
    return paged_attention_verify_reference(
        q, k_pages, v_pages, block_tables, context_lens, sm_scale)


# -- K2: flash-attention forward ---------------------------------------------
# Layout [b, s, h, d]; GQA maps q head i to kv head i // (h // kh); causal
# masks are bottom-right aligned (row r sees columns <= r + sk - sq).

def flash_attention_available(q, k=None, v=None, causal=False):
    """Shape gate: [b, s, h, d] with d in (64, 128, 256), sequence
    lengths that are multiples of 128, kv heads dividing q heads, and
    sk >= sq when causal."""
    if getattr(q, "ndim", 0) != 4:
        return False
    b, s, h, d = q.shape
    if d not in (64, 128, 256) or s % 128 != 0:
        return False
    if (k is None) != (v is None):
        return False
    if k is not None and k.shape != v.shape:
        return False
    if k is not None:
        if k.ndim != 4:
            return False
        bk, sk, hk, dk = k.shape
        if bk != b or dk != d or hk == 0 or h % hk != 0 or sk % 128 != 0:
            return False
        if causal and sk < s:
            return False
    return True


def flash_attention_reference(q, k, v, causal=False, sm_scale=None):
    """Plain PyTorch version of K2: (o [b, sq, h, d] in q's dtype,
    lse [b, h, sq] fp32), computed in fp32."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(h // kh, dim=2)
    vf = v.float().repeat_interleave(h // kh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * sm_scale, kf)
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device) \
            .tril(diagonal=sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), vf)
    return o.to(q.dtype), lse


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None):
    """K2 outside autograd: (o, lse). On CUDA tensors this launches
    ``csrc/flash_fwd.cu`` (q, k and v made contiguous here); on CPU
    tensors it runs the plain version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _on_cpu(q, k, v):
        return flash_attention_reference(q, k, v, causal, sm_scale)
    return _flash_fwd(q, k, v, causal, sm_scale)


def _flash_fwd(q, k, v, causal, sm_scale):
    """K2 on contiguous CUDA tensors: (o, lse)."""
    if not flash_attention_available(q, k, v, causal):
        raise ValueError("flash attention kernel does not take these shapes "
                         f"(q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"causal={causal})")
    dtype = _kernel_dtype(q, k, v)
    if dtype != _DTYPE_CODE[torch.float32]:
        _need_aligned(q=q, k=k, v=v)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), b, sq, sk, h, kh, d,
                     float(sm_scale), int(bool(causal)), dtype)
    return o, lse


# -- K3: flash-attention backward --------------------------------------------
# From the saved q, k, v, o, lse and the cotangents (do, dlse):
#   delta = rowsum(do * o) - dlse          (outside the kernel, as in JAX)
#   p = exp(s - lse), dv = p^T do, ds = p * (do v^T - delta),
#   dk = sm_scale * ds^T q, dq = sm_scale * ds k
# per q head; for GQA the per-q-head dk/dv are summed over the head group
# outside the kernel (in fp32, from per-head values in the input dtype, as
# the JAX package sums them).

def _flash_delta(o, do, dlse):
    """[b, h, sq] fp32: rowsum(do * o) minus the lse cotangent (a missing
    one counts as zero)."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _sum_head_groups(d_h, kh):
    """Per-q-head [b, sk, h, d] gradients summed over each kv head's group
    of q heads, in fp32, returned in d_h's dtype."""
    b, sk, h, d = d_h.shape
    if h == kh:
        return d_h
    return d_h.reshape(b, sk, kh, h // kh, d).sum(3, dtype=torch.float32) \
        .to(d_h.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, dlse=None,
                                  causal=False, sm_scale=None):
    """Plain PyTorch version of K3: (dq, dk, dv) in the inputs' dtypes,
    from the explicit backward formulas in fp32 (not autograd of the
    dense forward)."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(h // kh, dim=2)
    vf = v.float().repeat_interleave(h // kh, dim=2)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf * sm_scale, kf)
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device) \
            .tril(diagonal=sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse.float()[..., None])
    delta = _flash_delta(o, do, dlse)
    dv_h = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sm_scale
    dk_h = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * sm_scale
    return (dq.to(q.dtype), _sum_head_groups(dk_h.to(k.dtype), kh),
            _sum_head_groups(dv_h.to(v.dtype), kh))


def flash_attention_bwd(q, k, v, o, lse, do, dlse=None, causal=False,
                        sm_scale=None):
    """K3: (dq, dk, dv) of ``flash_attention_with_lse`` given the
    cotangents do of o and dlse of lse (None counts as zero). On CUDA
    tensors this launches ``csrc/flash_bwd.cu``; q, k, v, o and do are
    made contiguous here. The source holds each pass's shared memory to
    a block's limit for every d the gate admits, and a launch that asks
    for more raises here with the CUDA error. On CPU tensors it runs the
    plain version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q, k, v, o, lse, do):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, dlse,
                                             causal, sm_scale)
    if not flash_attention_available(q, k, v, causal) or \
            o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash attention backward kernel does not take "
                         f"these shapes (q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, causal={causal})")
    dtype = _kernel_dtype(q, k, v, o, do)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse must be fp32 [{b}, {h}, {sq}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), \
        do.contiguous()
    lse = lse.contiguous()
    if dtype != _DTYPE_CODE[torch.float32]:
        _need_aligned(q=q, k=k, v=v, do=do)
    delta = _flash_delta(o, do, dlse)
    dq = torch.empty_like(q)
    dk_h = torch.empty((b, sk, h, d), dtype=k.dtype, device=k.device)
    dv_h = torch.empty_like(dk_h)
    FLASH_BWD.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk_h.data_ptr(), dv_h.data_ptr(),
                     b, sq, sk, h, kh, d, float(sm_scale),
                     int(bool(causal)), dtype)
    return dq, _sum_head_groups(dk_h, kh), _sum_head_groups(dv_h, kh)


# K2 and K3 as ``torch.library`` ops: a fake or meta tensor has no data
# pointer, so ``torch.export`` and a static placeholder pass through the op
# (its fake from shapes alone) where a ctypes call could not. The ops are
# defined through ``torch.library.Library``: ``custom_op`` would wrap each
# kernel in a dynamo guard whose first call imports ``torch._dynamo`` (~2 s
# alone, ~10 s in each of several processes starting at once).

def _flash_bwd_impl(q, k, v, o, lse, do, dlse, causal, sm_scale):
    # the module's name, looked up at each call (tests wrap it to count K3)
    return flash_attention_bwd(q, k, v, o, lse, do, dlse, causal, sm_scale)


_LIB = torch.library.Library("paddle_tpu_torch", "DEF")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "float sm_scale) -> (Tensor, Tensor)")
_LIB.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
            "Tensor do, Tensor? dlse, bool causal, float sm_scale) "
            "-> (Tensor, Tensor, Tensor)")
for _key in ("CPU", "CUDA"):   # each wrapper splits by device itself
    _LIB.impl("flash_fwd", flash_attention_fwd, _key)
    _LIB.impl("flash_bwd", _flash_bwd_impl, _key)
flash_fwd_op = torch.ops.paddle_tpu_torch.flash_fwd.default
flash_bwd_op = torch.ops.paddle_tpu_torch.flash_bwd.default


def _need_gate(q, k, v, causal, what):
    if not flash_attention_available(q, k, v, causal):
        raise ValueError(f"flash attention {what} kernel does not take these "
                         f"shapes (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"causal={causal})")


@torch.library.register_fake("paddle_tpu_torch::flash_fwd")
def _flash_fwd_fake(q, k, v, causal, sm_scale):
    _need_gate(q, k, v, causal, "forward")
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, sq), dtype=torch.float32)


@torch.library.register_fake("paddle_tpu_torch::flash_bwd")
def _flash_bwd_fake(q, k, v, o, lse, do, dlse, causal, sm_scale):
    _need_gate(q, k, v, causal, "backward")
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, sm_scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.sm_scale = causal, sm_scale


def _flash_backward(ctx, do, dlse):
    """K3 from the saved q, k, v, o, lse; a missing cotangent counts as
    zero. K3 has no double backward."""
    if torch.is_grad_enabled():
        raise RuntimeError(
            "flash attention has no double backward (K3 computes its "
            "gradients without a graph): create_graph=True cannot "
            "pass through it")
    q, k, v, o, lse = ctx.saved_tensors
    if do is None:
        do = torch.zeros_like(o)
    dq, dk, dv = flash_bwd_op(q, k, v, o, lse, do, dlse, ctx.causal,
                              ctx.sm_scale)
    return dq, dk, dv, None, None


torch.library.register_autograd(
    "paddle_tpu_torch::flash_fwd", _flash_backward, setup_context=_flash_setup)


def flash_attention_with_lse(q, k, v, causal=False, sm_scale=None):
    """(o [b, sq, h, d], lse [b, h, sq] fp32), both differentiable: the
    counterpart of the JAX package's custom-vjp ``_flash_core_lse``,
    through the op ``paddle_tpu_torch::flash_fwd`` and its backward
    ``paddle_tpu_torch::flash_bwd``. On CUDA tensors the forward launches
    K2 (``csrc/flash_fwd.cu``) and the backward K3 (``csrc/flash_bwd.cu``);
    on CPU tensors both run their plain versions. Strided q, k, v (column
    slices of the packed qkv) are made contiguous once, here, and saved so
    for the backward. K3 has no double backward: a backward asked to
    build a graph (``create_graph=True``) raises, on either device."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return flash_fwd_op(q.contiguous(), k.contiguous(), v.contiguous(),
                        bool(causal), float(sm_scale))


def flash_attention_values(q, k, v, causal=False, sm_scale=None):
    """K2's o alone; its backward is K3 with a zero lse cotangent."""
    return flash_attention_with_lse(q, k, v, causal, sm_scale)[0]


# -- K4/K5: packed varlen attention ------------------------------------------
# Layout q [Tq, h, d], k/v [Tk, h, d] (kv heads == q heads), cu_seqlens
# [B + 1] int32 prefix offsets. Token t belongs to segment
# searchsorted(cu, t, right=True): 1..B for the packed sequences, B + 1
# for tokens at or past cu[B] (as in the JAX package). A q token sees the
# k tokens of its own segment; causal is absolute i >= j, which is the
# per-segment causal mask when cu_q == cu_k (the gate's condition).
# Rows and columns past T are bound-checked in the kernels: the JAX
# package's 128-token padding is a tile device and is not ported.

_NEG_INF = -1e30   # the reference's finite mask value (pallas_kernels.py:34)
_VL_BLOCK = 64     # K4's q and kv tile; K5's but for fp32 at d = 256


def _vl_bwd_block(d, dtype):
    """K5's tile rows: 64, or 32 for the fp32 route at d = 256 so each
    pass's fp32 tiles fit a block's shared memory (the 16-bit routes' tiles
    fit 64 rows at every d)."""
    return 32 if d == 256 and dtype == torch.float32 else _VL_BLOCK


# [(weakref(cu_q), weakref(cu_k), (cu_q._version, cu_k._version), equal)]
_CU_EQ_CACHE = []


def _cu_seqlens_equal(cu_q, cu_k):
    """cu_q == cu_k by value. A pair is compared once (for CUDA tensors,
    one sync) and the verdict cached by identity and version, with
    weakrefs so the cache pins no tensor (the JAX package's
    ``_cu_seqlens_equal`` keys on identity alone, which holds for its
    immutable arrays). An in-place write bumps ``_version``, through a
    view as well, so a cu buffer reused with new values is compared
    again. Inference tensors keep no version: they are compared every
    time and never cached."""
    if cu_q.shape != cu_k.shape:
        return False
    if cu_q.is_inference() or cu_k.is_inference():
        return torch.equal(cu_q.long(), cu_k.long().to(cu_q.device))
    versions = (cu_q._version, cu_k._version)
    for ref_q, ref_k, ver, eq in _CU_EQ_CACHE:
        if ref_q() is cu_q and ref_k() is cu_k and ver == versions:
            return eq
    eq = torch.equal(cu_q.long(), cu_k.long().to(cu_q.device))
    _CU_EQ_CACHE.append((weakref.ref(cu_q), weakref.ref(cu_k), versions, eq))
    del _CU_EQ_CACHE[:-16]  # bound the scan; dead refs age out with it
    return eq


def flash_attention_varlen_available(q, k, v, cu_q, cu_k, causal):
    """Shape gate for K4/K5 (the JAX package's contract minus its backend
    check and 512-token floor): [T, h, d] operands with d in (64, 128,
    256), k and v [Tk, h, d], and for causal cu_q is cu_k or equal to it
    by value (self-attention packing)."""
    for t in (q, k, v):
        if getattr(t, "ndim", 0) != 3:
            return False
    _, h, d = q.shape
    if d not in (64, 128, 256):
        return False
    if tuple(k.shape[1:]) != (h, d) or v.shape != k.shape:
        return False
    if causal:
        return cu_q is cu_k or _cu_seqlens_equal(cu_q, cu_k)
    return True


def _segment_ids(cu, t):
    """[t] int32: each packed token's segment, searchsorted(cu, i,
    right=True)."""
    pos = torch.arange(t, device=cu.device, dtype=cu.dtype)
    return torch.searchsorted(cu, pos, right=True, out_int32=True)


def _segment_bounds(cu, t):
    """[B + 3] int64: segment s spans tokens [bounds[s], bounds[s + 1])
    for s in 0..B+1 (segment 0 is empty when cu[0] == 0)."""
    cu = cu.long()
    return torch.cat([cu.new_zeros(1), cu, cu.new_full((1,), t)])


def _tile_spans(seg, t, block):
    """Per tile of ``block`` tokens: (first token, last token, segment of
    the first, segment of the last). Segments are consecutive, so these
    bound every segment the tile holds."""
    first = torch.arange(0, t, block, device=seg.device)
    last = (first + block).clamp(max=t) - 1
    return first, last, seg[first].long(), seg[last].long()


def _to_tiles(lo, hi, block, n_tiles):
    """Token range [lo, hi) as the tile range that covers it, empty when
    the token range is."""
    lo_t = lo // block
    hi_t = torch.where(hi > lo, (hi + block - 1) // block, lo_t)
    hi_t = hi_t.clamp(0, n_tiles)
    return torch.minimum(lo_t, hi_t).int(), hi_t.int()


class VarlenPlan(NamedTuple):
    """What K4 and K5 read besides the operands, all int32 on the
    operands' device: segment ids per token, per q tile the kv tile range
    [kv_lo, kv_hi), and per kv tile the q tile range [q_lo, q_hi), at
    ``block`` tokens per tile."""
    seg_q: torch.Tensor
    seg_k: torch.Tensor
    kv_lo: torch.Tensor
    kv_hi: torch.Tensor
    q_lo: torch.Tensor
    q_hi: torch.Tensor
    block: int


def varlen_plan(cu_q, cu_k, tq, tk, causal, block=_VL_BLOCK):
    """Segment ids and tile ranges, by torch ops on cu's device with no
    host sync. Per q tile (the counterpart of ``_vl_ranges``): the k
    tokens of its first through last segment, clipped to its last row
    when causal. Per kv tile (its inverse, for the dk/dv pass): the q
    tokens of its first through last segment, raised to its first column
    when causal."""
    seg_q, seg_k = _segment_ids(cu_q, tq), _segment_ids(cu_k, tk)
    bounds_q, bounds_k = _segment_bounds(cu_q, tq), _segment_bounds(cu_k, tk)
    n_q, n_k = -(-tq // block), -(-tk // block)
    top_q, top_k = len(bounds_q) - 1, len(bounds_k) - 1

    _, last, smin, smax = _tile_spans(seg_q, tq, block)
    lo = bounds_k[smin.clamp(max=top_k)]
    hi = bounds_k[(smax + 1).clamp(max=top_k)]
    if causal:
        hi = torch.minimum(hi, last + 1)
    kv_lo, kv_hi = _to_tiles(lo, hi, block, n_k)

    first, _, smin, smax = _tile_spans(seg_k, tk, block)
    lo = bounds_q[smin.clamp(max=top_q)]
    hi = bounds_q[(smax + 1).clamp(max=top_q)]
    if causal:
        lo = torch.maximum(lo, first)
    q_lo, q_hi = _to_tiles(lo, hi, block, n_q)
    return VarlenPlan(seg_q, seg_k, kv_lo, kv_hi, q_lo, q_hi, block)


def _segment_pairs(cu_q, cu_k, tq, tk):
    """[(q0, q1, k0, k1)] of every segment with tokens on both sides (one
    host sync: the plain versions loop over segments)."""
    bq = _segment_bounds(cu_q, tq).tolist()
    bk = _segment_bounds(cu_k, tk).tolist()
    return [(bq[s], bq[s + 1], bk[s], bk[s + 1])
            for s in range(min(len(bq), len(bk)) - 1)
            if bq[s + 1] > bq[s] and bk[s + 1] > bk[s]]


def _segment_scores(q, k, q0, q1, k0, k1, causal, sm_scale):
    """fp32 [h, Lq, Lk] scores of one segment and its visibility mask
    (absolute i >= j when causal)."""
    s = torch.einsum("qhd,khd->hqk", q[q0:q1].float() * sm_scale,
                     k[k0:k1].float())
    keep = None
    if causal:
        rows = torch.arange(q0, q1, device=q.device)
        cols = torch.arange(k0, k1, device=q.device)
        keep = rows[:, None] >= cols[None, :]
    return s, keep


def flash_attention_varlen_reference(q, k, v, cu_q, cu_k, causal=False,
                                     sm_scale=None):
    """Plain PyTorch version of K4: (o [Tq, h, d] in q's dtype, lse
    [h, Tq] fp32 natural-log), dense fp32 attention of each q segment
    against its k segment, so memory is the sum of Lq * Lk, not Tq * Tk.
    A row that sees no key gets o = +0 and lse = -1e30."""
    tq, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    o = torch.zeros(tq, h, d, dtype=torch.float32, device=q.device)
    lse = torch.full((h, tq), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    for q0, q1, k0, k1 in _segment_pairs(cu_q, cu_k, tq, k.shape[0]):
        s, keep = _segment_scores(q, k, q0, q1, k0, k1, causal, sm_scale)
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        seg_lse = torch.logsumexp(s, dim=-1)              # [h, Lq]
        seen = torch.isfinite(seg_lse)
        p = torch.where(seen[..., None], torch.exp(s - seg_lse[..., None]),
                        torch.zeros_like(s))
        o[q0:q1] = torch.einsum("hqk,khd->qhd", p, v[k0:k1].float())
        lse[:, q0:q1] = torch.where(seen, seg_lse,
                                    torch.full_like(seg_lse, _NEG_INF))
    return o.to(q.dtype), lse


def _varlen_delta(o, do):
    """[h, Tq] fp32: rowsum(do * o), outside the kernel as in JAX."""
    return (do.float() * o.float()).sum(-1).transpose(0, 1).contiguous()


def flash_attention_varlen_bwd_reference(q, k, v, o, lse, do, cu_q, cu_k,
                                         causal=False, sm_scale=None):
    """Plain PyTorch version of K5: (dq, dk, dv) in the inputs' dtypes,
    from the explicit backward formulas in fp32 per segment, with the
    reference's guard p = exp(min(s - lse, 0))."""
    tq, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    delta = _varlen_delta(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    lse = lse.float()
    for q0, q1, k0, k1 in _segment_pairs(cu_q, cu_k, tq, k.shape[0]):
        s, keep = _segment_scores(q, k, q0, q1, k0, k1, causal, sm_scale)
        p = torch.exp(torch.clamp(s - lse[:, q0:q1, None], max=0.0))
        if keep is not None:
            p = torch.where(keep, p, torch.zeros_like(p))
        dof = do[q0:q1].float()
        dv[k0:k1] = torch.einsum("hqk,qhd->khd", p, dof)
        dp = torch.einsum("qhd,khd->hqk", dof, v[k0:k1].float())
        ds = p * (dp - delta[:, q0:q1, None])
        dq[q0:q1] = torch.einsum("hqk,khd->qhd", ds, k[k0:k1].float()) \
            * sm_scale
        dk[k0:k1] = torch.einsum("hqk,qhd->khd", ds, q[q0:q1].float()) \
            * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_varlen(q, k, v, cu_q, cu_k, causal, *same_dtype):
    """Raise on what K4/K5 do not take; return the dtype code of q, k, v
    and ``same_dtype``."""
    if not flash_attention_varlen_available(q, k, v, cu_q, cu_k, causal):
        raise ValueError("varlen flash attention kernel does not take these "
                         f"shapes (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, causal={causal})")
    if cu_q.dtype != torch.int32 or cu_k.dtype != torch.int32:
        raise TypeError("cu_seqlens must be int32")
    return _kernel_dtype(q, k, v, *same_dtype)


def flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, causal=False,
                               sm_scale=None, plan=None):
    """K4: (o [Tq, h, d], lse [h, Tq] fp32). On CUDA tensors this
    launches ``csrc/flash_varlen_fwd.cu`` over ``plan`` (made here at 64
    tokens per tile when not given): bf16 and fp16 on its tensor-core
    route, fp32 on its scalar route; q, k and v are made contiguous, and
    16-bit ones must start on a 16-byte boundary. On CPU tensors it runs
    the plain version."""
    _refuse_capture("K4 (varlen flash forward)", q, k, v, cu_q, cu_k)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q, k, v, cu_q, cu_k):
        return flash_attention_varlen_reference(q, k, v, cu_q, cu_k, causal,
                                                sm_scale)
    dtype = _check_varlen(q, k, v, cu_q, cu_k, causal)
    tq, h, d = q.shape
    tk = k.shape[0]
    if plan is None:
        plan = varlen_plan(cu_q, cu_k, tq, tk, causal)
    if plan.block != _VL_BLOCK:
        raise ValueError(f"K4 takes {_VL_BLOCK}-token tiles, the plan has "
                         f"{plan.block}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if dtype != _DTYPE_CODE[torch.float32]:
        _need_aligned(q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty((h, tq), dtype=torch.float32, device=q.device)
    # scratch: the order in which the 16-bit route starts the q tiles
    order = torch.empty(plan.kv_lo.numel(), dtype=torch.int32,
                        device=q.device)
    FLASH_VARLEN_FWD.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        plan.seg_q.data_ptr(), plan.seg_k.data_ptr(), plan.kv_lo.data_ptr(),
        plan.kv_hi.data_ptr(), order.data_ptr(), o.data_ptr(),
        lse.data_ptr(), tq, tk, h, d, float(sm_scale), int(bool(causal)),
        dtype)
    return o, lse


def flash_attention_varlen_bwd(q, k, v, o, lse, do, cu_q, cu_k,
                               causal=False, sm_scale=None, plan=None):
    """K5: (dq, dk, dv) of K4's o given its cotangent do. On CUDA tensors
    this launches ``csrc/flash_varlen_bwd.cu``: bf16 and fp16 on its
    tensor-core route (a dq pass over the plan's per-q-tile kv ranges,
    which also computes delta = rowsum(do * o), then a dk/dv pass over its
    per-kv-tile q ranges), fp32 on its scalar route (delta computed here,
    then the dk/dv and the dq pass); a plan at another tile size than the
    route's (``_vl_bwd_block``) is made anew, and 16-bit operands must
    start on a 16-byte boundary. On CPU tensors it runs the plain version."""
    _refuse_capture("K5 (varlen flash backward)", q, k, v, o, lse, do, cu_q,
                    cu_k)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q, k, v, o, lse, do, cu_q, cu_k):
        return flash_attention_varlen_bwd_reference(q, k, v, o, lse, do,
                                                    cu_q, cu_k, causal,
                                                    sm_scale)
    dtype = _check_varlen(q, k, v, cu_q, cu_k, causal, o, do)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be shaped like q {tuple(q.shape)}")
    tq, h, d = q.shape
    tk = k.shape[0]
    if lse.dtype != torch.float32 or tuple(lse.shape) != (h, tq):
        raise ValueError(f"lse must be fp32 [{h}, {tq}], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    block = _vl_bwd_block(d, q.dtype)
    if plan is None or plan.block != block:
        plan = varlen_plan(cu_q, cu_k, tq, tk, causal, block)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    lse = lse.contiguous()
    if dtype != _DTYPE_CODE[torch.float32]:
        _need_aligned(q=q, k=k, v=v, o=o, do=do)
        # the 16-bit routes' dq pass computes delta from do and o
        delta = torch.empty((h, tq), dtype=torch.float32, device=q.device)
    else:
        delta = _varlen_delta(o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    # scratch: the orders in which the 16-bit route starts the kv tiles of
    # the dk/dv pass and the q tiles of the dq pass
    order = torch.empty(plan.q_lo.numel() + plan.kv_lo.numel(),
                        dtype=torch.int32, device=q.device)
    FLASH_VARLEN_BWD.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        o.data_ptr(), lse.data_ptr(), delta.data_ptr(), plan.seg_q.data_ptr(),
        plan.seg_k.data_ptr(), plan.kv_lo.data_ptr(), plan.kv_hi.data_ptr(),
        plan.q_lo.data_ptr(), plan.q_hi.data_ptr(), order.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), tq, tk, h, d, block,
        float(sm_scale), int(bool(causal)), dtype)
    return dq, dk, dv


class FlashAttentionVarlen(torch.autograd.Function):
    """Packed varlen flash attention: the counterpart of the JAX package's
    custom-vjp ``_flash_varlen_core``: returns o. Forward: K4 on CUDA
    tensors, the plain version on CPU ones; it saves q, k, v, o, lse, cu
    and (on the card) the plan of segment ids and tile ranges. Backward:
    K5 likewise, over the forward's plan (made anew only for the fp32
    route at d = 256, whose tiles are 32 rows). The integer cu_seqlens
    get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, causal, sm_scale):
        _refuse_capture("K4 (varlen flash forward)", q, k, v, cu_q, cu_k)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        plan = None
        if not _on_cpu(q, k, v, cu_q, cu_k):
            plan = varlen_plan(cu_q, cu_k, q.shape[0], k.shape[0], causal)
        o, lse = flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, causal,
                                            sm_scale, plan)
        ctx.save_for_backward(q, k, v, o, lse, cu_q, cu_k,
                              *(plan[:6] if plan is not None else ()))
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, cu_q, cu_k, *ranges = ctx.saved_tensors
        plan = VarlenPlan(*ranges, _VL_BLOCK) if ranges else None
        dq, dk, dv = flash_attention_varlen_bwd(
            q, k, v, o, lse, do, cu_q, cu_k, ctx.causal, ctx.sm_scale, plan)
        return dq, dk, dv, None, None, None, None


def flash_attention_varlen_values(q, k, v, cu_q, cu_k, sm_scale,
                                  causal=False):
    """Packed varlen flash attention on [T, h, d] tensors with [B + 1]
    int32 cu_seqlens: o [Tq, h, d], differentiable in q, k and v. On CUDA
    tensors the forward launches K4 (``csrc/flash_varlen_fwd.cu``) and the
    backward K5 (``csrc/flash_varlen_bwd.cu``); on CPU tensors both run
    their plain versions."""
    return FlashAttentionVarlen.apply(q, k, v, cu_q, cu_k, bool(causal),
                                      float(sm_scale))
