"""paddle_tpu_torch.inference.serving — single-replica serving over a
block-paged KV cache (counterpart: ``paddle_tpu.inference.serving``).

- ``kv_cache``     — PagedKVCache pools on the device + free-list
  allocator, per-sequence BlockTable (page 0 reserved as the null page);
- ``prefix_cache`` — content-hash-chained full-page reuse across
  requests (refcounts + LRU reclaim feeding the allocator);
- ``scheduler``    — continuous-batching policy (admit / evict / shed /
  queue limit) + Request lifecycle and typed errors;
- ``sampling``     — the shared temperature / top-k / top-p rule, keyed
  by (seed, position);
- ``speculator``   — NGramSpeculator prompt-lookup drafter;
- ``engine``       — ServingEngine: prefill, decode and speculative
  verify steps over the pools, the paged-attention kernel per layer.

Not ported yet: the executable cache, the open-loop load generator, the
fleet (replica, router, autoscaler) and the degradation controller.
"""
from .engine import ServingConfig, ServingEngine, serve
from .kv_cache import BlockTable, CacheFull, PagedKVCache
from .prefix_cache import PrefixCache
from .sampling import filter_logits, sample_tokens
from .scheduler import (EngineOverloaded, Request, RequestTimeout,
                        RequestTooLarge, Scheduler)
from .speculator import NGramSpeculator

__all__ = [
    "ServingConfig", "ServingEngine", "serve", "PagedKVCache",
    "BlockTable", "CacheFull", "PrefixCache", "Request", "Scheduler",
    "RequestTimeout", "RequestTooLarge", "EngineOverloaded",
    "NGramSpeculator", "filter_logits", "sample_tokens",
]
