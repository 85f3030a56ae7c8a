"""paddle_tpu_torch.inference.serving — the request-level serving plane
(counterpart: ``paddle_tpu.inference.serving``).

One engine:

- ``kv_cache``     — PagedKVCache pools on the device + free-list
  allocator, per-sequence BlockTable (page 0 reserved as the null page);
- ``prefix_cache`` — content-hash-chained full-page reuse across
  requests (refcounts + LRU reclaim feeding the allocator), and the
  affinity digest of resident chain keys a replica advertises;
- ``scheduler``    — continuous-batching policy (admit / evict / shed /
  queue limit) + Request lifecycle and typed errors;
- ``sampling``     — the shared temperature / top-k / top-p rule, keyed
  by (seed, position), and ``speculative_accept``;
- ``speculator``   — NGramSpeculator prompt-lookup drafter;
- ``engine``       — ServingEngine: prefill, decode and speculative
  verify steps over the pools, the paged-attention kernel per layer;
- ``compile_cache`` — CUDA-graph capture of decode and verify, with
  digest-verified manifests shared by every replica reading the cache;
- ``load``         — seeded open-loop load driver, the closed-loop fleet
  client and ``summarize``.

The fleet, over the membership ``TCPStore`` (``distributed/store.py``):
``fleet`` (the ``__srv`` key schema, the generation and the exactly-once
completion CAS, as the reference writes them), ``replica``
(ServingReplica membership, drain and digest-gated bundles in the
reference's format; the replica CLI), ``router`` (discovery,
health-check, affinity and occupancy routing, drain and failover
re-queue), ``autoscaler`` (the policy loop scaling through the drain
protocol) and ``degrade`` (the brownout ladder and load shedding).
"""
from .autoscaler import Autoscaler, AutoscalerConfig
from .compile_cache import CompileCache
from .degrade import DegradationController, DegradeConfig
from .engine import ServingConfig, ServingEngine, serve
from .kv_cache import BlockTable, CacheFull, PagedKVCache
from .load import (ClosedLoopClient, run_open_loop, summarize,
                   synth_requests)
from .prefix_cache import PrefixCache
from .replica import (BundleDigestError, EngineHarness, ServingReplica,
                      load_bundle, save_bundle)
from .router import ServingRouter
from .sampling import filter_logits, sample_tokens, speculative_accept
from .scheduler import (EngineOverloaded, Request, RequestTimeout,
                        RequestTooLarge, Scheduler)
from .speculator import NGramSpeculator

__all__ = [
    "ServingConfig", "ServingEngine", "serve", "PagedKVCache",
    "BlockTable", "CacheFull", "PrefixCache", "Request", "Scheduler",
    "RequestTimeout", "RequestTooLarge", "EngineOverloaded",
    "run_open_loop", "synth_requests", "summarize", "ClosedLoopClient",
    "ServingRouter", "ServingReplica", "EngineHarness",
    "BundleDigestError", "save_bundle", "load_bundle",
    "NGramSpeculator", "sample_tokens", "speculative_accept",
    "filter_logits", "Autoscaler", "AutoscalerConfig", "CompileCache",
    "DegradationController", "DegradeConfig",
]
