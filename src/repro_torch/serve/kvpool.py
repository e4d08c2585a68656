"""Host-side paged KV pool: fixed pages, per-request tables, freelist (port
of ``repro/serve/kvpool.py``).

Device layout (one pool per attention slot, stacked over periods by
:func:`repro_torch.models.transformer.init_paged_pools`):

    (n_pages, page_size, 2 * kv_heads, head_dim)

K and V for one position live fused in one page row, K on even head rows
and V on odd, so the attention kernel reads one position's K and V for a
group as one contiguous run. Page 0 is the reserved null page: padded table
entries and inactive-row writes go there, and it is never read because
those rows report length 0, so it may hold anything.

This module owns only the accounting: which physical pages belong to which
request, what is free, and the high-water and churn counters the scheduler
exports. The device pools are written by the decode and prefill steps
through the table this class maintains. :meth:`KVPool.reserve` holds pages
out of circulation (external pool pressure: a fault drill's squeeze), which
the scheduler meets exactly as it meets real demand.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

NULL_PAGE = 0
# Owner of the pages reserve() holds out of circulation: never a real
# request id (the engine's ids count up from 0).
RESERVED_RID = -1


class PoolExhausted(RuntimeError):
    """Raised by :meth:`KVPool.alloc` when the freelist cannot satisfy a
    request; the scheduler catches it and preempts instead."""


class KVPool:
    """Freelist allocator over ``n_pages`` physical pages of ``page_size``
    token positions each. Page 0 is reserved (null page) and never leaves
    the allocator."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (null + 1), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # pop() from the tail hands pages out in ascending id order
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._owner: Dict[int, int] = {}     # page id -> request id
        self.alloc_count = 0
        self.free_count = 0
        self.high_water = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages (the null page is not one)."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._owner)

    def utilization(self) -> float:
        return self.used_pages / self.capacity

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to store ``n_tokens`` positions (0 tokens -> 0)."""
        return -(-n_tokens // self.page_size)

    def alloc(self, n: int, rid: int) -> List[int]:
        """Take ``n`` pages for request ``rid``; raises :class:`PoolExhausted`
        (allocating nothing) when fewer than ``n`` are free."""
        if n > len(self._free):
            raise PoolExhausted(f"request {rid} needs {n} pages, only {len(self._free)} of {self.capacity} free")
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            self._owner[pg] = rid
        self.alloc_count += n
        self.high_water = max(self.high_water, self.used_pages)
        return pages

    def release(self, pages: Sequence[int], rid: int) -> None:
        """Return a request's pages to the freelist. Double-free and
        foreign-page release raise: a leak here would serve one request's KV
        to another."""
        for pg in pages:
            owner = self._owner.get(pg)
            if owner is None:
                raise ValueError(f"release of unowned page {pg} (rid {rid})")
            if owner != rid:
                raise ValueError(f"request {rid} releasing page {pg} owned by {owner}")
            del self._owner[pg]
            self._free.append(pg)
        self.free_count += len(pages)

    def owner(self, page: int):
        return self._owner.get(page)

    def reserve(self, n: int) -> List[int]:
        """Take up to ``n`` pages out of circulation under the owner
        ``RESERVED_RID``. Never raises: reserves what is free and returns the
        pages for :meth:`unreserve`."""
        n = min(n, len(self._free))
        return self.alloc(n, RESERVED_RID) if n > 0 else []

    def unreserve(self, pages: Sequence[int]) -> None:
        """Return pages taken by :meth:`reserve` to the freelist."""
        if pages:
            self.release(pages, RESERVED_RID)


def pool_shape(n_pages: int, page_size: int, n_kv_heads: int, head_dim: int) -> tuple:
    """Shape of one (unstacked) device pool in the fused layout."""
    return (n_pages, page_size, 2 * n_kv_heads, head_dim)
