"""Refcounted paged-block allocator (bookkeeping side).

The actual cache tensors live in the executor as pooled torch tensors of shape
(num_pages, page_size, ...); this class tracks allocation, sharing
(refcounts — the CoW substrate) and free lists.  Two instances exist in
ForkKV mode: one for the shared bCache, one for the per-agent rCache
(decoupled lifecycles, paper §5.2).

With tiered KV offload enabled (``ServeConfig.host_tier_bytes > 0``) the
engine wraps both pools in :class:`~repro_torch.serving.tiers.TieredPagePool`,
which adds the host/disk tiers; callers tell the two apart by the
``is_tiered`` class attribute.
"""
from __future__ import annotations

from typing import List, Optional, Sequence


class PagePool:
    is_tiered = False      # a tiered pool overrides (DESIGN.md §10)

    def __init__(self, num_pages: int, page_size: int, name: str = "pool"):
        self.num_pages = num_pages
        self.page_size = page_size
        self.name = name
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref = [0] * num_pages
        # high-water / accounting
        self.alloc_count = 0
        self.oom_count = 0

    # -------------------------------------------------------------- alloc
    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            self.oom_count += 1
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self._ref[p] == 0
            self._ref[p] = 1
        self.alloc_count += n
        return pages

    # ------------------------------------------------------------ sharing
    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert self._ref[p] > 0, f"{self.name}: incref on free page {p}"
            self._ref[p] += 1

    def decref(self, pages: Sequence[int]) -> List[int]:
        """Returns pages that became free."""
        freed = []
        for p in pages:
            assert self._ref[p] > 0, f"{self.name}: decref on free page {p}"
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def refcount(self, page: int) -> int:
        return self._ref[page]

    # ---------------------------------------------------------- metrics
    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def utilization(self) -> float:
        return self.used_pages / max(1, self.num_pages)

    def pages_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)
