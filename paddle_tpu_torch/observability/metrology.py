"""In-process performance metrology: device-ceiling probes run as scan
chains on the card (counterpart: ``paddle_tpu/observability/metrology.py``,
whose probe names, report keys and chain statistics it keeps).

The probes run in the training process, on the tracer's perf timebase, so
a ceiling and the step it bounds are two spans on one timeline.

Probe methodology (every probe but the per-dispatch one):

1. Chain: the work is repeated ``chain`` times as one CUDA graph, replayed
   between two CUDA events, so no launch enters the ceiling (the
   reference runs the chain as one jitted program for the same reason).
   On the CPU (``device="cpu"``) the chain runs eagerly on the host clock.
2. Warm-up discard: the first ``warmup`` timed chains never enter the
   sample set.
3. Repeat until stable: chains repeat until the sample set's MAD/median
   falls under ``stability_rtol`` or the rep budget runs out; the report
   carries median, MAD and a ``stable`` flag either way.

``probe_gemm_per_dispatch`` is the deliberate exception: one
``paddle.linalg.matmul`` on paddle Tensors per measurement with a
synchronise after each call, launch and framework cost exposed, so a run
shows how far that methodology sits below the chained ceiling.

Sizing the card forces: the H100's L2 holds 50 MB, so a stream over 32 MB
(the reference's ``quick`` size) would read L2 and report more than the
3.35 TB/s of HBM. The port's plans stream at least four times
``torch.cuda.get_device_properties(0).L2_cache_size``. Likewise a 512^3
bf16 product fills 16 of 132 SMs, so the plans' bf16 ceiling probe is
4096^3.

Spans: each probe body runs under ``metrology.probe`` (attrs carry the
result) with a ``metrology.rep`` event per timed chain. Entry points run
on the card (``device="cuda"``) and raise without one unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import statistics
import time

from . import trace

# scan-chain defaults: small enough for a smoke run, overridable per probe
DEFAULT_WARMUP = 1
DEFAULT_MIN_REPS = 3
DEFAULT_MAX_REPS = 8
DEFAULT_STABILITY_RTOL = 0.10


def _median_mad(samples):
    med = statistics.median(samples)
    mad = statistics.median([abs(s - med) for s in samples])
    return med, mad


def scan_chain(sample_fn, warmup=DEFAULT_WARMUP, min_reps=DEFAULT_MIN_REPS,
               max_reps=DEFAULT_MAX_REPS,
               stability_rtol=DEFAULT_STABILITY_RTOL, probe="probe"):
    """Run ``sample_fn() -> elapsed_seconds`` as a scan chain.

    Discards ``warmup`` calls, then samples until MAD/median <=
    ``stability_rtol`` (at least ``min_reps``, at most ``max_reps``).
    Returns ``{"median_s", "mad_s", "samples_ms", "reps", "warmup",
    "stable"}``; each timed rep emits a ``metrology.rep`` event.
    """
    if max_reps < min_reps:
        max_reps = min_reps
    for _ in range(warmup):
        sample_fn()
    samples = []
    stable = False
    while len(samples) < max_reps:
        dt = sample_fn()
        samples.append(dt)
        trace.event("metrology.rep", probe=probe, ms=round(dt * 1e3, 4))
        if len(samples) >= min_reps:
            med, mad = _median_mad(samples)
            if med > 0 and mad / med <= stability_rtol:
                stable = True
                break
    med, mad = _median_mad(samples)
    return {"median_s": med, "mad_s": mad,
            "samples_ms": [round(s * 1e3, 4) for s in samples],
            "reps": len(samples), "warmup": warmup, "stable": stable}


def _result(name, value, unit, chain_stats, **attrs):
    med = chain_stats["median_s"]
    out = {"probe": name, "value": round(value, 4), "unit": unit,
           "median_ms": round(med * 1e3, 4),
           "mad_ms": round(chain_stats["mad_s"] * 1e3, 4),
           "mad_over_median": round(chain_stats["mad_s"] / med, 4)
           if med > 0 else None,
           "stable": chain_stats["stable"], "reps": chain_stats["reps"],
           "warmup": chain_stats["warmup"],
           "samples_ms": chain_stats["samples_ms"]}
    out.update(attrs)
    return out


def _device(device):
    """``torch.device(device)``; a CUDA device needs a card."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "metrology probes run on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to probe the host")
    return dev


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _torch_dtype(dtype):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]


def chain_sampler(fn, chain, dev):
    """``sample() -> seconds`` of ``chain`` calls of ``fn``: on the card,
    one CUDA graph of the chain replayed between two CUDA events; on the
    CPU, the calls on the host clock."""
    import torch
    if dev.type != "cuda":
        def sample():
            t0 = time.perf_counter()
            for _ in range(chain):
                fn()
            return time.perf_counter() - t0
        return sample
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # warm up off the capture
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(chain):
                fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)

    def sample():
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3

    sample.graph = graph   # keeps the graph and its pool alive
    return sample


def probe_hbm_stream(mbytes=64, dtype="float32", chain=8, device="cuda",
                     **scan_kw):
    """Device-memory read+write bandwidth: an in-place add over ``mbytes``,
    chained ``chain`` times. GB/s counts the read AND the write of every
    pass."""
    import numpy as np
    import torch
    dev = _device(device)
    name = f"hbm_stream_{dtype}_{mbytes}mb"
    with trace.span("metrology.probe", probe=name) as sp:
        itemsize = 2 if dtype == "bfloat16" else 4
        n = int(mbytes * 2 ** 20 / itemsize)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            n, dtype=np.float32)).to(dev, _torch_dtype(dtype))
        nbytes = x.numel() * x.element_size()
        # an addition, not a near-1 multiply: each pass is a real read and
        # write of every element
        st = scan_chain(chain_sampler(lambda: x.add_(1.0), chain, dev),
                        probe=name, **scan_kw)
        gbps = 2.0 * nbytes * chain / st["median_s"] / 1e9
        res = _result(name, gbps, "GB/s", st, mbytes=mbytes, dtype=dtype,
                      chain=chain, bytes_per_pass=nbytes)
        sp.set_attrs(value=res["value"], unit="GB/s",
                     stable=res["stable"])
    return res


def gemm_chain_fn(n=512, dtype="bfloat16", chain=8, device="cuda"):
    """The chained-GEMM probe's body and its operands: ``chained(a, b)``
    runs ``chain`` dependent n^3 products."""
    import numpy as np
    import torch
    dev = _device(device)
    rng = np.random.default_rng(0)
    scale = 1.0 / np.sqrt(n)
    a, b = (torch.from_numpy(rng.standard_normal((n, n)) * scale)
            .to(dev, _torch_dtype(dtype)) for _ in range(2))

    def chained(x, y):
        for _ in range(chain):
            x = x @ y
        return x

    return chained, (a, b)


def probe_gemm(n=512, dtype="bfloat16", chain=8, device="cuda", **scan_kw):
    """Dense GEMM rate: ``chain`` dependent n^3 products in one CUDA graph
    replay, the launch-free ceiling number (TF/s)."""
    dev = _device(device)
    name = f"gemm_{dtype}_n{n}"
    with trace.span("metrology.probe", probe=name) as sp:
        chained, (a, b) = gemm_chain_fn(n=n, dtype=dtype, chain=1,
                                        device=dev)
        st = scan_chain(chain_sampler(lambda: chained(a, b), chain, dev),
                        probe=name, **scan_kw)
        tflops = 2.0 * n ** 3 * chain / st["median_s"] / 1e12
        res = _result(name, tflops, "TF/s", st, n=n, dtype=dtype,
                      chain=chain)
        sp.set_attrs(value=res["value"], unit="TF/s",
                     stable=res["stable"])
    return res


def probe_gemm_per_dispatch(n=512, dtype="float32", calls=8, device="cuda",
                            **scan_kw):
    """The standalone-probe methodology, for comparison: one
    ``paddle.linalg.matmul`` on paddle Tensors per measurement with a
    synchronise after each call: launch, framework and synchronise
    exposed."""
    import numpy as np
    import torch
    from ..ops import linalg
    from ..tensor import Tensor
    dev = _device(device)
    name = f"gemm_per_dispatch_{dtype}_n{n}"
    with trace.span("metrology.probe", probe=name) as sp:
        rng = np.random.default_rng(0)
        scale = 1.0 / np.sqrt(n)
        ta, tb = (Tensor._wrap(torch.from_numpy(
            (rng.standard_normal((n, n)) * scale).astype("float32"))
            .to(dev, _torch_dtype(dtype))) for _ in range(2))

        def sample():
            t0 = time.perf_counter()
            for _ in range(calls):
                linalg.matmul(ta, tb)
                _sync(dev)   # per-call sync: the methodology under test
            return time.perf_counter() - t0

        st = scan_chain(sample, probe=name, **scan_kw)
        tflops = 2.0 * n ** 3 * calls / st["median_s"] / 1e12
        res = _result(name, tflops, "TF/s", st, n=n, dtype=dtype,
                      calls=calls, methodology="per-dispatch-synced")
        sp.set_attrs(value=res["value"], unit="TF/s",
                     stable=res["stable"])
    return res


def probe_collective_bus(mbytes=4, chain=2, device="cuda", **scan_kw):
    """Collective bus rate through the comm plane: an fp32 SUM all-reduce
    of ``mbytes`` over the world, launched through the plane (so it lands
    in the plane's accounting and spans). Several processes: ring bus GB/s
    (2*(n-1)/n * bytes / t). One process: the plane's local reduce,
    reported with ``plane: "local"`` so it is never mistaken for a wire
    number."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ..distributed import collective as c
    from ..distributed import comm_plane
    dev = _device(device)
    name = f"collective_bus_fp32_{mbytes}mb"
    with trace.span("metrology.probe", probe=name) as sp:
        world = c.get_world_size()
        group = c.get_group()
        t = torch.from_numpy(np.random.default_rng(0).standard_normal(
            int(mbytes * 2 ** 20 / 4)).astype(np.float32)).to(dev)
        nbytes = t.numel() * t.element_size()
        plane = comm_plane.get_plane()

        def once():
            if c._solo(group):
                plane.run_inline(
                    lambda: comm_plane.reduce_array(t, group,
                                                    c.ReduceOp.SUM),
                    label="metrology.bus")
            else:
                plane.launch(
                    lambda: dist.all_reduce(t, group=group.pg,
                                            async_op=True),
                    label="metrology.bus",
                    span="metrology.collective").wait()

        def sample():
            t0 = time.perf_counter()
            for _ in range(chain):
                once()
            _sync(dev)
            return time.perf_counter() - t0

        st = scan_chain(sample, probe=name, **scan_kw)
        plane.drain()   # a probe leaves no pending work to the loop after it
        if world > 1:
            bus = 2.0 * (world - 1) / world * nbytes * chain \
                / st["median_s"] / 1e9
            plane_kind = "ring"
        else:
            bus = nbytes * chain / st["median_s"] / 1e9
            plane_kind = "local"
        res = _result(name, bus, "GB/s", st, mbytes=mbytes, world=world,
                      chain=chain, plane=plane_kind)
        sp.set_attrs(value=res["value"], unit="GB/s",
                     stable=res["stable"])
    return res


# -- probe sets ---------------------------------------------------------------

def _stream_mb(mbytes, dev):
    """``mbytes``, raised to four L2 caches on the card (module doc)."""
    import torch
    if dev.type != "cuda":
        return mbytes
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return max(mbytes, -(-4 * l2 // 2 ** 20))


def run_probes(level="quick", scan_kw=None, device="cuda"):
    """Run the standard probe set; returns a JSON-serializable report.

    ``level="smoke"`` is the preflight set (small shapes, seconds);
    ``"quick"`` the default; ``"full"`` adds GEMM shapes and a bf16
    stream.
    """
    import torch
    dev = _device(device)
    kw = dict(scan_kw or {}, device=dev)
    if level == "smoke":
        plan = [
            lambda: probe_hbm_stream(mbytes=_stream_mb(8, dev), chain=4, **kw),
            lambda: probe_gemm(n=256, dtype="float32", chain=4, **kw),
            lambda: probe_gemm(n=256, dtype="bfloat16", chain=4, **kw),
            lambda: probe_gemm_per_dispatch(n=256, calls=4, **kw),
            lambda: probe_collective_bus(mbytes=1, **kw),
        ]
    elif level == "full":
        plan = [
            lambda: probe_hbm_stream(mbytes=_stream_mb(128, dev), chain=8,
                                     **kw),
            lambda: probe_hbm_stream(mbytes=_stream_mb(64, dev),
                                     dtype="bfloat16", chain=8, **kw),
            lambda: probe_gemm(n=512, dtype="float32", **kw),
            lambda: probe_gemm(n=4096, dtype="bfloat16", **kw),
            lambda: probe_gemm(n=512, dtype="bfloat16", **kw),
            lambda: probe_gemm(n=1024, dtype="bfloat16", **kw),
            lambda: probe_gemm(n=2048, dtype="bfloat16", **kw),
            lambda: probe_gemm_per_dispatch(n=512, **kw),
            lambda: probe_gemm_per_dispatch(n=512, dtype="bfloat16", **kw),
            lambda: probe_collective_bus(mbytes=8, **kw),
        ]
    else:  # quick
        plan = [
            lambda: probe_hbm_stream(mbytes=_stream_mb(32, dev), chain=8,
                                     **kw),
            lambda: probe_gemm(n=512, dtype="float32", **kw),
            lambda: probe_gemm(n=4096, dtype="bfloat16", **kw),
            lambda: probe_gemm_per_dispatch(n=512, **kw),
            lambda: probe_collective_bus(mbytes=4, **kw),
        ]
    with trace.span("metrology.run_probes", level=level):
        probes = [fn() for fn in plan]
    cuda = dev.type == "cuda"
    return {"artifact": "metrology_probes", "level": level,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "platform": "gpu" if cuda else "cpu", "probes": probes}


def probe_value(report, prefix):
    """First probe in ``report`` whose name starts with ``prefix``
    (helper for consumers deriving ceilings), or None."""
    for p in report.get("probes", []):
        if p["probe"].startswith(prefix):
            return p
    return None
