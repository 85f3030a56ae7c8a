"""Block-paged KV cache: the serving plane's memory system (counterpart:
``paddle_tpu/inference/serving/kv_cache.py``).

Two pool tensors per cache, ``k`` and ``v``, each
``[num_layers, num_pages, page_size, num_heads * head_dim]`` on the
device, hold every sequence's KV history as fixed-size pages. A sequence
owns an ordered page list (its block table); appending a token writes one
``[h*d]`` row into (page, offset). The engine writes the pools IN PLACE
(``index_put_``), where the JAX engine donates them to its programs and
installs the returned arrays.

Page 0 is reserved as the null page: the allocator never hands it out,
so padded block-table entries and masked scatter targets are always
valid indices (inactive batch slots write their garbage row there, and
page 0 is only ever read under a mask).

Allocation is a free list (O(1) allocate/free). When it runs dry the
cache asks its ``reclaim`` hook (the prefix cache's LRU of refcount-0
pages) before reporting exhaustion.
"""
from __future__ import annotations

from collections import deque

import torch

from ... import resolve_device


class CacheFull(RuntimeError):
    """No free page and nothing reclaimable — the caller must evict."""


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


class PagedKVCache:
    """Owner of the page pools and the free list."""

    def __init__(self, num_layers, num_pages, page_size, num_heads,
                 head_dim, dtype="float32", device=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.device = resolve_device(device)
        shape = (self.num_layers, self.num_pages, self.page_size,
                 self.num_heads * self.head_dim)
        dtype = _torch_dtype(dtype)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free = deque(range(1, self.num_pages))
        self._reclaim = None  # () -> page_id or None (prefix-cache LRU)

    def set_reclaim_hook(self, fn):
        self._reclaim = fn

    @property
    def free_page_count(self):
        return len(self._free)

    def allocate_page(self):
        """One free page id, reclaiming from the prefix cache's LRU when
        the free list is dry. Raises CacheFull when neither has one."""
        if not self._free and self._reclaim is not None:
            reclaimed = self._reclaim()
            if reclaimed is not None:
                self._free.append(reclaimed)
        if not self._free:
            raise CacheFull(
                f"KV cache exhausted: {self.num_pages - 1} usable pages "
                f"of {self.page_size} tokens all live")
        return self._free.popleft()

    def free_page(self, page_id):
        if page_id == 0:
            raise ValueError("page 0 is the reserved null page")
        self._free.append(page_id)

    def can_allocate(self, n_pages):
        """Cheap admission check: free pages + reclaimable pages."""
        avail = len(self._free)
        if self._reclaim is not None:
            avail += getattr(self._reclaim, "reclaimable", lambda: 0)()
        return avail >= n_pages


class BlockTable:
    """One sequence's ordered page list plus its logical length.

    ``pages[i]`` holds tokens [i*page_size, (i+1)*page_size); only the
    last page may be partly filled. ``shared`` marks pages acquired from
    the prefix cache: read-only here (always full, never the append
    target) and released, not freed, on teardown.
    """

    def __init__(self, cache):
        self._cache = cache
        self.pages = []
        self.shared = []            # parallel bools
        self.length = 0             # tokens stored

    @property
    def num_pages(self):
        return len(self.pages)

    def adopt_shared(self, page_ids):
        """Prefix-cache hit: seed the table with already-filled shared
        pages covering ``len(page_ids) * page_size`` tokens."""
        if self.pages:
            raise RuntimeError("adopt_shared on a non-empty table")
        self.pages.extend(page_ids)
        self.shared.extend(True for _ in page_ids)
        self.length = len(page_ids) * self._cache.page_size

    def slot_for_append(self):
        """(page_id, offset) where the next token's KV row lands,
        allocating a fresh private page when the tail is full. Raises
        CacheFull when a page is needed and none is available."""
        ps = self._cache.page_size
        off = self.length % ps
        if off == 0 and self.length == len(self.pages) * ps:
            self.pages.append(self._cache.allocate_page())
            self.shared.append(False)
        return self.pages[-1], off

    def append_slots(self, n):
        """Slots for the next ``n`` tokens: (page_ids, offsets) lists."""
        pages, offs = [], []
        for _ in range(n):
            p, o = self.slot_for_append()
            pages.append(p)
            offs.append(o)
            self.length += 1
        return pages, offs

    def truncate(self, new_length):
        """Speculative-decode rollback: drop the KV state past
        ``new_length`` by truncating the page list (a block-table edit and
        free-list pushes, never a pool copy). Only private tail pages can
        be dropped; a rollback into a shared prefix page raises. Returns
        the number of pages freed."""
        if new_length > self.length or new_length < 0:
            raise ValueError(
                f"truncate({new_length}) outside [0, {self.length}]")
        ps = self._cache.page_size
        if new_length < sum(self.shared) * ps:
            raise RuntimeError(
                "rollback into a shared prefix-cache page — commit "
                "points can never precede the prompt's full pages")
        keep = (new_length + ps - 1) // ps
        freed = 0
        while len(self.pages) > keep:
            self._cache.free_page(self.pages.pop())
            self.shared.pop()
            freed += 1
        self.length = new_length
        return freed

    def release(self, prefix_cache=None):
        """Tear the table down: shared pages go back to the prefix cache
        (refcount drop), private pages are freed. Returns the number of
        pages freed outright."""
        freed = 0
        for page, is_shared in zip(self.pages, self.shared):
            if is_shared and prefix_cache is not None:
                prefix_cache.release(page)
            else:
                self._cache.free_page(page)
                freed += 1
        self.pages = []
        self.shared = []
        self.length = 0
        return freed

    def padded(self, max_pages):
        """Block-table row padded with the null page for the kernel."""
        row = list(self.pages[:max_pages])
        row.extend(0 for _ in range(max_pages - len(row)))
        return row
