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

The in-program forms (``quantized_all_reduce`` and
``quantized_all_gather`` over a mesh axis, ``hierarchical_all_reduce``,
``quantized_replicate``) are shard_map programs in the reference; they
wait for the tensor-parallel and ZeRO slice and raise (ROADMAP A7).
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


def quantize_blockwise(x, cfg=None):
    """x (any shape, any float dtype) -> (codes [nblocks, block] in the
    wire dtype, scales [nblocks] in ``cfg.scale_dtype``). An all-zero
    block has scale 0 and decodes to exact zeros."""
    cfg = cfg or QuantConfig()
    qmax = _QMAX[cfg.dtype]
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    bs = int(cfg.block_size)
    nb = max(-(-n // bs), 1)
    flat = torch.nn.functional.pad(flat, (0, nb * bs - n))
    blocks = flat.reshape(nb, bs)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = amax / qmax
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, 1.0),
                      torch.zeros_like(scale))
    scaled = blocks * inv
    if cfg.dtype == "int8":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = scaled.to(_wire_dtype(cfg))
    return q, scale.reshape(nb).to(_SCALE_DTYPES[cfg.scale_dtype])


def dequantize_blockwise(q, scales, shape, dtype=torch.float32, cfg=None):
    """(codes, scales) -> a tensor of ``shape`` in ``dtype``; the multiply
    is fp32 whatever the wire and scale dtypes."""
    size = int(np.prod(shape)) if len(shape) else 1
    vals = q.to(torch.float32) * scales.to(torch.float32)[:, None]
    return vals.reshape(-1)[:size].reshape(shape).to(dtype)


def quantization_roundtrip(x, cfg=None):
    """deq(quant(x)): what one crossing of the wire does to ``x``."""
    cfg = cfg or QuantConfig()
    q, s = quantize_blockwise(x, cfg)
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


def _in_program(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"comm_quant.{name} is an in-program (shard_map) collective; "
            "it waits for the tensor-parallel and ZeRO slice (ROADMAP A7)")
    refuse.__name__ = name
    return refuse


quantized_all_reduce = _in_program("quantized_all_reduce")
quantized_all_gather = _in_program("quantized_all_gather")
hierarchical_all_reduce = _in_program("hierarchical_all_reduce")
quantized_replicate = _in_program("quantized_replicate")


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
