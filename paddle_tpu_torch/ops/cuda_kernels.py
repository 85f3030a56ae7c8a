"""The port's hand-written Hopper kernels, their gates, wrappers and
plain PyTorch versions.

Counterpart: ``paddle_tpu/ops/pallas_kernels.py``. Two of its five TPU
kernels lie on the serving slice and are ported here:

- K1 ``_paged_verify_kernel`` -> ``csrc/paged_attention.cu``
  (``paged_attention*``): ragged paged attention for decode (one query
  row per slot) and speculative verify (k + 1 rows per slot);
- K2 ``_fwd_kernel`` -> ``csrc/flash_fwd.cu`` (``flash_attention*``):
  the flash-attention forward, returning o and the natural-log lse.

Each kernel sits beside its plain PyTorch version (``*_reference``),
which the CPU tests and ``chip_smoke.py`` hold the kernel against. A
wrapper takes the plain version only when every tensor it was given lies
on the CPU; on CUDA tensors it launches the kernel or raises, and never
falls back. Each launch adds one to the kernel's ``launches`` count.

The gates (``*_available``) keep the JAX package's shape contract, minus
its TPU-only backend check and its 512-token floor; they decide by shape
alone, never by whether a kernel built.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448   # bytes of shared memory one H100 block can use


class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times a wrapper launched it."""

    def __init__(self, name, entry, argtypes, replaces):
        self.name = name
        self.source = f"paddle_tpu_torch/csrc/{name}.cu"
        self.replaces = replaces
        self._entry = entry
        self._argtypes = argtypes
        self._fn = None
        self.launches = 0

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
        self.launches += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

PAGED_ATTENTION = Kernel(
    "paged_attention", "paged_attention_fwd",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "paddle_tpu/ops/pallas_kernels.py:1167")
FLASH_FWD = Kernel(
    "flash_fwd", "flash_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "paddle_tpu/ops/pallas_kernels.py:195")
KERNELS = (PAGED_ATTENTION, FLASH_FWD)


def build_kernels():
    """Build every kernel's library now, one ``nvcc`` per source, all in
    parallel. Returns {name: (seconds, compiler output)}."""
    return _build.build([k.name for k in KERNELS])


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


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


def _kernel_dtype(*tensors):
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, all alike; got "
                        f"{sorted(map(str, dtypes))}")
    return _DTYPE_CODE[dtypes.pop()]


def _need_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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


def paged_attention_verify_decode(q, k_pages, v_pages, block_tables,
                                  context_lens, sm_scale=None):
    """K1 on [B, KQ, h, d] queries: query row j of slot b attends over
    ``context_lens[b] + j`` tokens. On CUDA tensors this launches
    ``csrc/paged_attention.cu``; q may be strided (a column slice of the
    packed qkv) and is made contiguous here, a copy of B*KQ*h*d values.
    On CPU tensors it runs the plain version."""
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
    # the kernel's shared memory: q and acc rows, 32-token K and V tiles,
    # probabilities and three per-row statistics, all fp32
    smem = 4 * (2 * kq * d + 2 * 32 * d + kq * 32 + 3 * kq)
    if smem > _MAX_SMEM:
        raise ValueError(f"KQ={kq} at d={d} needs {smem} bytes of shared "
                         f"memory, more than a block has")
    q = q.contiguous()
    out = torch.empty_like(q)
    PAGED_ATTENTION.launch(
        q.device, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        b, kq, h, d, k_pages.shape[1], block_tables.shape[1],
        float(sm_scale), dtype)
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


def flash_attention_with_lse(q, k, v, causal=False, sm_scale=None):
    """K2: (o [b, sq, h, d], lse [b, h, sq] fp32). On CUDA tensors this
    launches ``csrc/flash_fwd.cu``; strided q, k, v (column slices of the
    packed qkv) are made contiguous here. The kernel is forward only: on
    CUDA with grad mode on and an input that requires grad it raises, as
    the backward kernel belongs to the training slice. On CPU tensors it
    runs the plain version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q, k, v):
        return flash_attention_reference(q, k, v, causal, sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the CUDA flash-attention kernel is forward only; its backward "
            "comes with the training slice of the port — run under "
            "torch.no_grad()")
    if not flash_attention_available(q, k, v, causal):
        raise ValueError("flash attention kernel does not take these shapes "
                         f"(q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"causal={causal})")
    dtype = _kernel_dtype(q, k, v)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), b, sq, sk, h, kh, d,
                     float(sm_scale), int(bool(causal)), dtype)
    return o, lse


def flash_attention_values(q, k, v, causal=False, sm_scale=None):
    """K2's o alone."""
    return flash_attention_with_lse(q, k, v, causal, sm_scale)[0]
