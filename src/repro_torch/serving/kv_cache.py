"""Paged KV-cache pool: host-side page accounting for the serving hot path.

The device side is a shared page pool per attention layer
(``models.layers.PagedSpec``: ``k_pages``/``v_pages`` ``[P, page, Hkv,
hd]`` plus per-slot page tables).  This module is the control-plane half:
a free list over page ids, allocated when the continuous batcher admits a
request and grown one page at a time as its decode position crosses page
boundaries.  The same table values index every layer's pool, so the
accounting runs once per slot, not once per layer.

Page 0 is reserved as the scratch page (see ``PagedSpec``): inactive
batcher slots keep all-zero page tables, and their garbage writes land
there.  It is never handed out, never freed.

Invariants:
  * a page id is either in the free list or owned by exactly one slot;
  * ``free`` of an id not currently allocated raises (double-free);
  * after every request finishes, ``in_use == 0`` (no leaked pages).
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.models.layers import PagedSpec

__all__ = ["PagePool", "PagedSpec"]


class PagePool:
    """Free-list allocator over the page ids of one replica's pool."""

    def __init__(self, spec: PagedSpec) -> None:
        self.page_size = spec.page_size
        self.num_pages = spec.num_pages
        # LIFO free list: recently freed pages are re-used first (their
        # device blocks are the likeliest to still be in L2).
        self._free: List[int] = list(range(spec.num_pages - 1, 0, -1))
        self._allocated: set = set()
        self.alloc_failures = 0
        self.high_watermark = 0

    # -- views -------------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the reserved scratch page 0)."""
        return self.num_pages - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._allocated)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache rows."""
        return -(-max(tokens, 0) // self.page_size)

    def fits(self, tokens: int) -> bool:
        """Whether a request of ``tokens`` total length can EVER be held
        (even with the whole pool to itself)."""
        return self.pages_for(tokens) <= self.capacity

    # -- alloc / free ------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, all-or-nothing.  None when short."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._allocated.update(ids)
        self.high_watermark = max(self.high_watermark, self.in_use)
        return ids

    def free(self, ids: List[int]) -> None:
        for pid in ids:
            if pid not in self._allocated:
                raise ValueError(
                    f"double-free or foreign page id {pid} "
                    f"(allocated={sorted(self._allocated)})"
                )
            self._allocated.discard(pid)
            self._free.append(pid)

    def leaked(self) -> int:
        """Pages neither free nor owned: 0 unless accounting is broken."""
        return self.capacity - self.available - self.in_use
