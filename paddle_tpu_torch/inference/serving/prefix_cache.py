"""Prefix caching: content-hashed KV pages shared across requests
(counterpart: ``paddle_tpu/inference/serving/prefix_cache.py``). Users
share system prompts, so their prefill work is the same work over and
over.

Keying: a page holding prompt tokens ``t[i*P:(i+1)*P]`` is keyed by the
HASH CHAIN ``key_i = sha256(key_{i-1} || tokens_chunk)`` — the key
commits to the ENTIRE prefix up to the page's end, not just the page's
own tokens, so two prompts share a page only when everything before it
is identical too (KV state depends on the whole prefix). Only FULL
pages are cached: a partial tail page is still append-mutable, and the
engine always leaves >= 1 tail token to prefill on a hit, so shared
pages are immutable by construction.

Lifecycle: a hit ``acquire``s pages (refcount++); sequence teardown
``release``s them; refcount-0 pages stay RESIDENT in an LRU — their
contents remain valid — until the allocator's reclaim hook evicts one
for reuse. ``publish`` transfers a finished sequence's full prompt
pages into the cache (dedup-aware: chunks already keyed keep the
existing page).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict


def _chunk_keys(tokens, page_size):
    """Hash-chain keys for every FULL page-sized chunk of ``tokens``."""
    keys = []
    h = b"\x00" * 32
    n_full = len(tokens) // page_size
    for i in range(n_full):
        chunk = tokens[i * page_size:(i + 1) * page_size]
        m = hashlib.sha256()
        m.update(h)
        m.update(b",".join(str(int(t)).encode() for t in chunk))
        h = m.digest()
        keys.append(h.hex())
    return keys


class PrefixCache:
    """Content-addressed index over resident KV pages."""

    def __init__(self, cache, enabled=True):
        self._cache = cache                 # PagedKVCache
        self.enabled = enabled
        self._pages = {}                    # key -> page_id
        self._refs = {}                     # key -> refcount
        self._by_page = {}                  # page_id -> key
        self._lru = OrderedDict()           # key -> None (refcount == 0)
        self._touched = OrderedDict()       # resident key, publish recency
        self.hits = 0
        self.lookups = 0
        if enabled:
            def hook(_self=self):
                return _self._reclaim_one()
            hook.reclaimable = lambda _self=self: len(_self._lru)
            cache.set_reclaim_hook(hook)

    # -- lookup / refcounts --------------------------------------------------
    def lookup(self, tokens, page_size=None, count=True):
        """Longest cached chain of full pages covering a prefix of
        ``tokens``. Returns (keys, page_ids) — possibly empty. Does NOT
        acquire; call ``acquire`` on the pages actually adopted.
        ``count=False`` = a budgeting peek (the scheduler re-plans a
        blocked queue head every step; only the prefill-time lookup is
        a statistically meaningful hit/miss)."""
        if not self.enabled:
            if count:
                self.lookups += 1
            return [], []
        if not count:
            return self._scan(tokens, page_size)
        self.lookups += 1
        keys, pages = self._scan(tokens, page_size)
        if pages:
            self.hits += 1
        return keys, pages

    def _scan(self, tokens, page_size=None):
        ps = page_size or self._cache.page_size
        keys, pages = [], []
        for key in _chunk_keys(tokens, ps):
            page = self._pages.get(key)
            if page is None:
                break
            keys.append(key)
            pages.append(page)
        return keys, pages

    def acquire(self, key):
        """Refcount++ on a cached page (a sequence adopted it)."""
        self._refs[key] += 1
        self._lru.pop(key, None)
        return self._pages[key]

    def try_acquire(self, keys, pages):
        """Acquire the longest PREFIX of (keys, pages) still resident —
        an earlier admission's allocations may have reclaimed LRU pages
        between the scheduler's lookup and this prefill. Returns the
        (keys, pages) actually adopted."""
        got_k, got_p = [], []
        for key, page in zip(keys, pages):
            if self._pages.get(key) != page:
                break
            self.acquire(key)
            got_k.append(key)
            got_p.append(page)
        return got_k, got_p

    def release(self, page_id):
        """Refcount-- by page id; at zero the page parks in the LRU
        (contents stay valid until reclaimed)."""
        key = self._by_page.get(page_id)
        if key is None:
            # the index entry was reclaimed while the page was still
            # referenced is impossible (reclaim only takes refcount-0
            # pages); an unknown page means it was never cached — free
            self._cache.free_page(page_id)
            return
        self._refs[key] -= 1
        if self._refs[key] <= 0:
            self._lru[key] = None
            self._lru.move_to_end(key)

    # -- population ----------------------------------------------------------
    def publish(self, tokens, table):
        """Transfer a sequence's full PROMPT pages into the cache before
        the table is released: their table entries flip to shared so
        ``BlockTable.release`` routes them back here (refcount -> 0,
        LRU-resident). ``tokens`` must be the prompt only — generated
        tokens never seed the index. Dedup: a chunk already keyed keeps
        the incumbent page; this sequence's duplicate stays private and
        is freed normally."""
        if not self.enabled:
            return 0
        ps = self._cache.page_size
        keys = _chunk_keys(tokens, ps)
        published = 0
        for i, key in enumerate(keys):
            if i >= len(table.pages):
                break
            page = table.pages[i]
            if table.shared[i]:
                continue                       # adopted on a hit already
            if key in self._pages:
                continue                       # incumbent wins; dup freed
            self._pages[key] = page
            self._by_page[page] = key
            self._refs[key] = 1                # held by this sequence
            table.shared[i] = True             # release() -> self.release
            published += 1
        # affinity index: every key of this prompt's resident chain
        # refreshes its recency, so a shared system prefix, touched by
        # every follower, stays at the hot end of the bounded digest the
        # replica advertises while one-off tails age out first
        for k in keys[:len(table.pages)]:
            if k in self._pages:
                self._touched[k] = None
                self._touched.move_to_end(k)
        return published

    # -- reclaim (the allocator's hook) --------------------------------------
    def _reclaim_one(self):
        """Evict the least-recently-released refcount-0 page and hand
        its id to the allocator. None when nothing is reclaimable."""
        while self._lru:
            key, _ = self._lru.popitem(last=False)
            if self._refs.get(key, 0) > 0:     # re-acquired since parking
                continue
            page = self._pages.pop(key)
            self._by_page.pop(page, None)
            self._refs.pop(key, None)
            # an evicted key stops being advertised (the router treats
            # affinity as a hint; the prefill-time re-lookup stays exact)
            self._touched.pop(key, None)
            return page
        return None

    def chain_heads(self, limit=32):
        """The most-recently-touched resident chain keys, newest first,
        at most ``limit``: the affinity digest a replica publishes beside
        its occupancy gauges. The keys are ``_chunk_keys``' own, which the
        router recomputes a prompt's chain with, so the two sides cannot
        drift."""
        if not self.enabled or not self._touched:
            return []
        out = list(self._touched)[-int(limit):]
        out.reverse()
        return out

    # -- introspection -------------------------------------------------------
    @property
    def resident_pages(self):
        return len(self._pages)

    @property
    def reclaimable_pages(self):
        return len(self._lru)
