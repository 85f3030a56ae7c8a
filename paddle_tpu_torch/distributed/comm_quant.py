"""Block-scaled quantized collectives, their eager part (counterpart:
``paddle_tpu/distributed/comm_quant.py``; EQuARX, arxiv 2506.17615).

- ``QuantConfig``: the wire format (int8 or fp8 e4m3 codes, elements per
  scale block, the scales' dtype, error feedback), and the active config
  that ``comm_quant=True`` resolves to.
- ``quantize_blockwise`` / ``dequantize_blockwise``: the reference's
  arithmetic in torch (fp32 amax over each block, scale = amax / qmax,
  codes = round-half-even(x / scale) clipped), so the same inputs give
  the same codes and scales in both packages.
- The two-phase quantized all-reduce (``reduce_quantized``) that
  ``all_reduce(quant=...)`` and ``DataParallel(comm_quant=...)`` run: a
  reduce-scatter of int8 codes and fp32 scales (one ``all_to_all``), fp32
  sums, then an all-gather of the summed chunks, each encoded once by its
  owner so every rank decodes the same bytes. Rank r owns chunk
  (r + 1) mod n and adds its own contribution unquantized, as the
  reference's ring does: at two ranks the numbers are the ring's; past
  two, each contribution is encoded once where the ring re-encodes its
  running partials every hop.
- ``np_encode`` / ``np_decode``: the host codec of a wire message.
- ``ErrorFeedback``: the per-key residual of the local compression error
  across repeated syncs (EF-SGD).

The in-program forms are ``shard_map`` programs over a mesh axis in the
reference. In the port each rank runs them on its own value, over that
axis's group of the default mesh (``mesh.group(axis_name)``; a ``Group``
is taken as it is), with the hops on the group's point-to-point exchange
(``sep_transport.permute``: CUDA tensors staged through the host on gloo,
chosen by backend and device):

- ``quantized_all_reduce(x, axis_name, cfg, op)``: the reference's
  two-phase ring. Chunks padded to a multiple of the block; n − 1
  reduce-scatter hops each encode the running fp32 partial and pass it to
  rank + 1, which decodes it and adds its own chunk unquantized; rank r
  then owns chunk (r + 1) mod n, encodes it once and circulates it n − 1
  hops, every rank decoding every chunk (its own from its own encoding).
  The same numbers as the reference at every n.
- ``quantized_all_gather(x, axis_name, cfg)``: x encoded once and
  circulated; the stacked [n, ...] decode, the same on every rank.
- ``hierarchical_all_reduce(x, ici_axis, dcn_axis, cfg, op)``: an fp32 SUM
  over the ici axis, then the quantized ring over dcn.
- ``quantized_replicate(value, mesh, cfg)``: a ZeRO-3 parameter's rows to
  the whole parameter, decoded from codes and scales gathered over its
  sharding group, equal bit for bit to the reference's encoding of the
  whole value: a scale block that straddles two ranks' rows takes its
  amax from both (each rank's partial amax of its edge blocks is
  all-gathered first).

``stats()``: the in-program forms' calls, hops and bytes this rank sent.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}
_SCALE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The wire format of one quantized payload: ``dtype`` ("int8" or
    "fp8_e4m3"), ``block_size`` elements per scale, ``scale_dtype``
    ("float32" or "bfloat16") and ``error_feedback`` (DataParallel keeps
    each rank's compression residual across syncs)."""

    dtype: str = "int8"
    block_size: int = 256
    scale_dtype: str = "float32"
    error_feedback: bool = False

    def __post_init__(self):
        if self.dtype not in _QMAX:
            raise ValueError(
                f"comm_quant wire dtype {self.dtype!r} not supported "
                f"(have {sorted(_QMAX)})")
        if self.block_size < 1:
            raise ValueError(f"bad block_size {self.block_size}")

    @classmethod
    def from_strategy(cls, configs):
        configs = dict(configs or {})
        return cls(dtype=configs.get("dtype", "int8"),
                   block_size=int(configs.get("block_size", 256)),
                   scale_dtype=configs.get("scale_dtype", "float32"),
                   error_feedback=bool(configs.get("error_feedback", False)))


def _wire_dtype(cfg):
    return torch.int8 if cfg.dtype == "int8" else torch.float8_e4m3fn


_active_config = None


def set_active_config(cfg):
    """Publish the strategy-level config (None clears). Collectives do not
    read it unless asked with ``quant=True``."""
    global _active_config
    if cfg is not None and not isinstance(cfg, QuantConfig):
        raise TypeError(f"expected QuantConfig or None, got {type(cfg)}")
    _active_config = cfg
    return cfg


def get_active_config():
    return _active_config


def resolve_config(quant):
    """None/False: no quantization; True: the active config (or the
    default one); a QuantConfig or a strategy dict: that config."""
    if quant is None or quant is False:
        return None
    if quant is True:
        return _active_config or QuantConfig()
    if isinstance(quant, QuantConfig):
        return quant
    if isinstance(quant, dict):
        return QuantConfig.from_strategy(quant)
    raise TypeError(f"bad quant config {quant!r}")


def _encode_blocks(blocks, amax, cfg, traced):
    """Codes of fp32 ``blocks`` [nb, block] with per-block ``amax`` [nb,
    1], and their fp32 scales [nb, 1]. ``traced``: the scale as XLA
    compiles amax / qmax in the reference's in-program forms (times the
    fp32 reciprocal of qmax, which can differ from the division in the
    last bit); else the division, as the reference computes it eagerly."""
    qmax = _QMAX[cfg.dtype]
    scale = amax * amax.new_tensor(1.0 / qmax) if traced else amax / qmax
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, 1.0),
                      torch.zeros_like(scale))
    scaled = blocks * inv
    if cfg.dtype == "int8":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = scaled.to(_wire_dtype(cfg))
    return q, scale


def quantize_blockwise(x, cfg=None, traced=False):
    """x (any shape, any float dtype) -> (codes [nblocks, block] in the
    wire dtype, scales [nblocks] in ``cfg.scale_dtype``). An all-zero
    block has scale 0 and decodes to exact zeros. ``traced``: the
    arithmetic of the reference's compiled forms (``_encode_blocks``)."""
    cfg = cfg or QuantConfig()
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    bs = int(cfg.block_size)
    nb = max(-(-n // bs), 1)
    flat = torch.nn.functional.pad(flat, (0, nb * bs - n))
    blocks = flat.reshape(nb, bs)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    q, scale = _encode_blocks(blocks, amax, cfg, traced)
    return q, scale.reshape(nb).to(_SCALE_DTYPES[cfg.scale_dtype])


def dequantize_blockwise(q, scales, shape, dtype=torch.float32, cfg=None):
    """(codes, scales) -> a tensor of ``shape`` in ``dtype``; the multiply
    is fp32 whatever the wire and scale dtypes."""
    size = int(np.prod(shape)) if len(shape) else 1
    vals = q.to(torch.float32) * scales.to(torch.float32)[:, None]
    return vals.reshape(-1)[:size].reshape(shape).to(dtype)


def quantization_roundtrip(x, cfg=None, traced=False):
    """deq(quant(x)): what one crossing of the wire does to ``x``."""
    cfg = cfg or QuantConfig()
    q, s = quantize_blockwise(x, cfg, traced)
    return dequantize_blockwise(q, s, tuple(x.shape), x.dtype, cfg)


def wire_nbytes(shape, cfg=None):
    """Bytes one payload of ``shape`` takes on the wire under ``cfg``
    (codes and scales)."""
    cfg = cfg or QuantConfig()
    n = int(np.prod(shape)) if len(shape) else 1
    nb = max(-(-n // int(cfg.block_size)), 1)
    scale_bytes = torch.finfo(_SCALE_DTYPES[cfg.scale_dtype]).bits // 8
    return nb * int(cfg.block_size) + nb * scale_bytes


def dense_nbytes(shape, dtype="float32"):
    n = int(np.prod(shape)) if len(shape) else 1
    return n * np.dtype(dtype).itemsize


def wire_view(q):
    """The codes as bytes gloo and NCCL move (fp8 has no collective
    dtype of its own)."""
    return q if q.dtype == torch.int8 else q.view(torch.uint8)


def np_encode(arr, cfg):
    """numpy array -> wire dict {qdata, scales, qshape, shape, dtype,
    cq}: about a quarter of ``arr.tobytes()`` for fp32 input."""
    arr = np.asarray(arr)
    q, s = quantize_blockwise(torch.from_numpy(arr.astype(np.float32)), cfg)
    return {"cq": {"dtype": cfg.dtype, "block_size": cfg.block_size,
                   "scale_dtype": cfg.scale_dtype},
            "qdata": wire_view(q).numpy().tobytes(),
            "scales": s.view(torch.int16).numpy().tobytes()
            if s.dtype == torch.bfloat16 else s.numpy().tobytes(),
            "qshape": tuple(q.shape), "shape": arr.shape,
            "dtype": str(arr.dtype)}


def np_decode(msg):
    """Inverse of ``np_encode``: a numpy array in the original dtype."""
    c = msg["cq"]
    cfg = QuantConfig(dtype=c["dtype"], block_size=c["block_size"],
                      scale_dtype=c["scale_dtype"])
    raw = np.frombuffer(msg["qdata"], dtype=np.int8 if cfg.dtype == "int8"
                        else np.uint8).reshape(msg["qshape"]).copy()
    q = torch.from_numpy(raw)
    if cfg.dtype != "int8":
        q = q.view(_wire_dtype(cfg))
    nb = msg["qshape"][0]
    if cfg.scale_dtype == "bfloat16":
        s = torch.from_numpy(np.frombuffer(msg["scales"], np.int16)
                             .copy()).view(torch.bfloat16)
    else:
        s = torch.from_numpy(np.frombuffer(msg["scales"], np.float32)
                             .copy())
    out = dequantize_blockwise(q, s.reshape(nb), tuple(msg["shape"]),
                               torch.float32, cfg)
    return out.numpy().astype(msg["dtype"], copy=False)


def _chunking(size, n, cfg):
    """Chunk length of an n-rank reduce-scatter: a multiple of the block,
    so no scale block spans two ranks' chunks."""
    chunk = -(-size // n)
    bs = int(cfg.block_size)
    return -(-chunk // bs) * bs


def _exchange(sends, group):
    """``all_to_all`` of per-destination (codes, scales): returns the
    (codes, scales) each source sent here, in rank order."""
    q = torch.stack([wire_view(s[0]) for s in sends])
    s = torch.stack([x[1] for x in sends])
    q_in, s_in = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(q_in, q, group=group.pg)
    dist.all_to_all_single(s_in, s, group=group.pg)
    return q_in, s_in


def _decode_rows(q_rows, s_rows, chunk, cfg):
    if cfg.dtype != "int8":
        q_rows = q_rows.view(_wire_dtype(cfg))
    return [dequantize_blockwise(q_rows[i], s_rows[i], (chunk,),
                                 torch.float32, cfg)
            for i in range(q_rows.shape[0])]


def reduce_scatter_quantized(parts, group, cfg):
    """``parts[k]`` (fp32, this rank's contribution to rank k): every
    contribution but this rank's own crosses the wire once as codes and
    scales; returns the fp32 sum of the contributions to this rank."""
    me, n = group.rank, group.nranks
    shape = parts[0].shape
    size = parts[0].numel()
    sends = [quantize_blockwise(p, cfg) for p in parts]
    q_in, s_in = _exchange(sends, group)
    dec = _decode_rows(q_in, s_in, -(-size // cfg.block_size)
                       * cfg.block_size, cfg)
    out = parts[me].reshape(-1).to(torch.float32).clone()
    for src in range(n):
        if src != me:
            out = dec[src][:size] + out
    return out.reshape(shape)


def reduce_quantized(flat, group, cfg):
    """The two-phase quantized SUM of a flat fp32 tensor over ``group``
    (every rank ends with the same values)."""
    n, me = group.nranks, group.rank
    size = flat.numel()
    chunk = _chunking(size, n, cfg)
    padded = torch.nn.functional.pad(flat.reshape(-1).to(torch.float32),
                                     (0, n * chunk - size))
    parts = padded.reshape(n, chunk)
    # phase 1: rank d owns chunk (d + 1) % n; each rank sends it its part
    owned = [(d + 1) % n for d in range(n)]
    sends = [quantize_blockwise(parts[owned[d]], cfg) for d in range(n)]
    q_in, s_in = _exchange(sends, group)
    dec = _decode_rows(q_in, s_in, chunk, cfg)
    red = parts[owned[me]].clone()
    for src in range(n):
        if src != me:
            red = dec[src] + red
    # phase 2: each owner encodes its sum once; every rank decodes all
    q_own, s_own = quantize_blockwise(red, cfg)
    qs = [torch.empty_like(wire_view(q_own)) for _ in range(n)]
    ss = [torch.empty_like(s_own) for _ in range(n)]
    dist.all_gather(qs, wire_view(q_own).contiguous(), group=group.pg)
    dist.all_gather(ss, s_own, group=group.pg)
    rows = _decode_rows(torch.stack(qs), torch.stack(ss), chunk, cfg)
    out = torch.empty(n * chunk, dtype=torch.float32, device=flat.device)
    for d in range(n):
        out[owned[d] * chunk:(owned[d] + 1) * chunk] = rows[d]
    return out[:size].reshape(flat.shape)


# -- the in-program forms over a mesh axis ------------------------------------
_STATS = {"calls": 0, "hops": 0, "bytes": 0}


def stats():
    """{'calls', 'hops', 'bytes'} of the in-program forms since the last
    ``reset_stats``: bytes this rank sent (codes and scales)."""
    return dict(_STATS)


def reset_stats():
    _STATS.update(calls=0, hops=0, bytes=0)


def _axis_group(axis_name):
    """The group of ``axis_name`` in the default mesh (a ``Group`` as it
    is)."""
    if hasattr(axis_name, "ranks"):
        return axis_name
    from .sharding_api import get_default_mesh
    return get_default_mesh().group(axis_name)


def _ring_hop(q, s, group, label):
    """(codes, scales) passed to rank + 1 of ``group``; returns what rank
    - 1 sent here."""
    from . import sep_transport
    n = group.nranks
    perm = [(i, (i + 1) % n) for i in range(n)]
    wire = wire_view(q)
    got_q, got_s = sep_transport.permute([wire, s], group, [perm, perm],
                                         label=label)
    _STATS["hops"] += 1
    _STATS["bytes"] += wire.numel() * wire.element_size() \
        + s.numel() * s.element_size()
    if q.dtype != got_q.dtype:
        got_q = got_q.view(q.dtype)
    return got_q, got_s


def _decode_add(q, s, own, cfg):
    """deq(q, s) + ``own`` (fp32, the chunk's length) as the reference's
    compiled ring computes it: XLA contracts the decode's multiply and the
    add into one fused multiply-add, emulated here in fp64, where the
    product of a code and an fp32 scale is exact."""
    if cfg.dtype != "int8":
        q = q.view(_wire_dtype(cfg))
    prod = q.to(torch.float64) * s.to(torch.float32).to(torch.float64)[:, None]
    return (prod.reshape(-1)[:own.numel()] + own.to(torch.float64)).to(
        torch.float32)


def quantized_all_reduce(x, axis_name, cfg=None, op="sum"):
    """The two-phase quantized all-reduce of this rank's ``x`` over
    ``axis_name`` ("sum" or "mean"); the same values on every rank."""
    cfg = cfg or QuantConfig()
    if op not in ("sum", "mean"):
        raise NotImplementedError(
            f"quantized all-reduce supports sum/mean, not {op!r} (max/min/"
            "prod do not commute with block-scaled integer accumulation)")
    group = _axis_group(axis_name)
    n = group.nranks
    if n == 1:
        return quantization_roundtrip(x, cfg, traced=True).to(x.dtype)
    _STATS["calls"] += 1
    me = group.rank
    shape, dtype = x.shape, x.dtype
    size = x.numel()
    chunk = _chunking(size, n, cfg)
    flat = torch.nn.functional.pad(x.reshape(-1).to(torch.float32),
                                   (0, n * chunk - size))
    parts = flat.reshape(n, chunk)
    part = parts[me]
    for t in range(n - 1):
        q, s = quantize_blockwise(part, cfg, traced=True)
        q, s = _ring_hop(q, s, group, "comm_quant.reduce_scatter")
        part = _decode_add(q, s, parts[(me - t - 1) % n], cfg)
    # this rank owns the whole sum of chunk (me + 1) mod n
    q, s = quantize_blockwise(part, cfg, traced=True)
    out = torch.zeros(n * chunk, dtype=torch.float32, device=x.device)
    own = (me + 1) % n
    out[own * chunk:(own + 1) * chunk] = dequantize_blockwise(
        q, s, (chunk,), torch.float32, cfg)
    for hop in range(1, n):
        q, s = _ring_hop(q, s, group, "comm_quant.all_gather")
        idx = (me + 1 - hop) % n
        out[idx * chunk:(idx + 1) * chunk] = dequantize_blockwise(
            q, s, (chunk,), torch.float32, cfg)
    res = out[:size].reshape(shape)
    if op == "mean":
        res = res * res.new_tensor(1.0 / n)     # XLA's x / n
    return res.to(dtype)


def quantized_all_gather(x, axis_name, cfg=None):
    """Every rank's ``x``, encoded once by its owner and circulated, as
    the stacked [n, ...] decode (the same on every rank)."""
    cfg = cfg or QuantConfig()
    group = _axis_group(axis_name)
    n = group.nranks
    if n == 1:
        return quantization_roundtrip(x, cfg, traced=True)[None].to(x.dtype)
    _STATS["calls"] += 1
    me = group.rank
    size = x.numel()
    q, s = quantize_blockwise(x, cfg, traced=True)
    out = torch.zeros((n, size), dtype=torch.float32, device=x.device)
    out[me] = dequantize_blockwise(q, s, (size,), torch.float32, cfg)
    for hop in range(1, n):
        q, s = _ring_hop(q, s, group, "comm_quant.all_gather")
        out[(me - hop) % n] = dequantize_blockwise(q, s, (size,),
                                                   torch.float32, cfg)
    return out.reshape((n,) + tuple(x.shape)).to(x.dtype)


def hierarchical_all_reduce(x, ici_axis, dcn_axis, cfg=None, op="sum"):
    """An fp32 all-reduce SUM over ``ici_axis``, then the quantized ring
    over ``dcn_axis`` (quantization spends its error only on the slow
    links); "mean" divides by n_ici x n_dcn."""
    from .collective import ReduceOp, all_reduce
    if op not in ("sum", "mean"):
        raise NotImplementedError(f"hierarchical all-reduce op {op!r}")
    ici, dcn = _axis_group(ici_axis), _axis_group(dcn_axis)
    part = x.detach().clone()
    if ici.nranks > 1:
        all_reduce(part, op=ReduceOp.SUM, group=ici)
    out = quantized_all_reduce(part, dcn, cfg, op="sum")
    if op == "mean":
        out = out * out.new_tensor(1.0 / (ici.nranks * dcn.nranks))
    return out.to(x.dtype)


def _edge_blocks(lo, m, bs):
    """The first and last scale block a rank holding elements [lo, lo +
    m) of the flat value touches."""
    return lo // bs, (lo + m - 1) // bs


def _block_starts(lo, m, bs):
    """The scale blocks whose first element is in [lo, lo + m)."""
    first, last = _edge_blocks(lo, m, bs)
    return [b for b in range(first, last + 1) if b * bs >= lo]


def quantized_replicate(value, mesh=None, cfg=None):
    """The whole parameter from ``value``, a ZeRO-3 parameter stored as
    its rows (``value._zero``): this rank encodes its elements with the
    scales of the whole value's blocks, the codes and the scales are
    all-gathered over the sharding group, and every rank decodes the
    whole value in ``value``'s dtype. A tensor that is not stored as
    rows is one codec round trip (no traffic)."""
    from .collective import all_gather
    cfg = cfg or QuantConfig()
    z = getattr(value, "_zero", None)
    t = value.detach()
    if z is None or tuple(t.shape) == tuple(z.full_shape) or z.n == 1:
        return quantization_roundtrip(t, cfg, traced=True).to(t.dtype)
    _STATS["calls"] += 1
    bs = int(cfg.block_size)
    n, me = z.n, z.index
    m = t.numel()
    total = n * m
    nb = max(-(-total // bs), 1)
    lo = me * m
    first, last = _edge_blocks(lo, m, bs)
    # this rank's elements laid into the whole value's blocks it touches
    local = torch.zeros((last - first + 1) * bs, dtype=torch.float32,
                        device=t.device)
    off = lo - first * bs
    local[off:off + m] = t.reshape(-1).to(torch.float32)
    blocks = local.reshape(-1, bs)
    amax = blocks.abs().amax(dim=1)
    # the edge blocks' partial amaxes from every rank, then each block's
    # amax over every rank that holds part of it
    edges = []
    all_gather(edges, torch.stack([amax[0], amax[-1]]), group=z.group)
    for j, e in enumerate(edges):
        fj, lj = _edge_blocks(j * m, m, bs)
        for b, a in ((fj, e[0]), (lj, e[1])):
            if first <= b <= last:
                amax[b - first] = torch.maximum(amax[b - first], a)
    q, scale = _encode_blocks(blocks, amax[:, None], cfg, traced=True)
    codes = wire_view(q).reshape(-1)[off:off + m].contiguous()
    # the scales of the blocks that start in this rank's elements
    own = _block_starts(lo, m, bs)
    width = -(-m // bs) + 1
    sc = torch.zeros(width, dtype=_SCALE_DTYPES[cfg.scale_dtype],
                     device=t.device)
    if own:
        sc[:len(own)] = scale.reshape(-1)[own[0] - first:
                                          own[-1] - first + 1].to(sc.dtype)
    got_q, got_s = [], []
    all_gather(got_q, codes, group=z.group)
    all_gather(got_s, sc, group=z.group)
    _STATS["bytes"] += codes.numel() + sc.numel() * sc.element_size() + 8
    q_all = torch.cat(got_q)
    q_all = torch.nn.functional.pad(q_all, (0, nb * bs - total))
    if cfg.dtype != "int8":
        q_all = q_all.view(_wire_dtype(cfg))
    s_all = torch.zeros(nb, dtype=sc.dtype, device=t.device)
    for j, s_j in enumerate(got_s):
        starts = _block_starts(j * m, m, bs)
        if starts:
            s_all[starts[0]:starts[-1] + 1] = s_j[:len(starts)]
    return dequantize_blockwise(q_all.reshape(nb, bs), s_all,
                                tuple(z.full_shape), t.dtype, cfg)


class ErrorFeedback:
    """Per-key fp32 residual of the local compression error across
    repeated quantized syncs: ``compensate`` adds the stored residual to
    the gradient and keeps g' - deq(quant(g')) for the next sync. The
    DataParallel reducer keys it by the parameter's name."""

    def __init__(self, cfg=None):
        self._cfg = cfg or QuantConfig()
        self._resid = {}

    def compensate(self, key, grad_value):
        g = grad_value.to(torch.float32)
        r = self._resid.get(key)
        if r is not None and r.shape == g.shape:
            g = g + r
        self._resid[key] = g - quantization_roundtrip(g, self._cfg)
        return g.to(grad_value.dtype)

    def reset(self):
        self._resid.clear()
