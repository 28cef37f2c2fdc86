"""Paged KV lane pool: block-table allocation for the slot table
(``repro.serve.pages`` without prefix sharing).

Each kv leaf is a pool of ``page_size``-token physical pages; each slot
holds an int32 block table mapping logical page ``i`` of its lane to a
physical page or the ``FREE`` sentinel. Lanes grow page by page and
release their pages to a free list, so pages in use track live tokens.

Layout invariants, the same as the reference's:

* logical lane coordinates are unchanged: token ``t`` lives at logical
  position ``t``; paging only remaps logical page ``t // page_size``;
* a slot's allocated pages are a logical prefix of its lane;
* ``FREE == num_pages``: a gather through it is clamped, a write through it
  dropped, so unallocated entries cost nothing;
* block tables carry one extra sentinel row (index ``num_slots``) that
  stays all-``FREE``.

Refcounts are kept (one reference per block-table entry) so the invariant
audit reads like the reference's. Page-level prefix sharing (probe,
publish, ``map_shared``, copy-on-write, the retained LRU and the fleet
index) comes with a later slice (ROADMAP Queue 1 item 7); without it no
page is ever shared, so no write needs a copy.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.errors import AuditError

__all__ = ["PagePool", "PageClass"]


class PageClass:
    """Bookkeeping for one lane width: free list, per-slot block table and
    per-page refcounts."""

    def __init__(self, width: int, num_slots: int, page_size: int,
                 num_pages: int):
        self.width = width
        self.lane_pages = -(-width // page_size)
        self.num_pages = num_pages
        self.free: List[int] = list(range(num_pages))
        self.table = np.full((num_slots + 1, self.lane_pages), num_pages,
                             np.int32)
        self.refcount = np.zeros(num_pages, np.int32)

    @property
    def FREE(self) -> int:
        return self.num_pages

    def available(self) -> int:
        return len(self.free)


class PagePool:
    """Fixed pool of physical KV pages + per-slot block tables, one width
    class per distinct lane width. ``pool_frac`` scales each class's page
    count relative to ``num_slots * lane_pages`` (floored at one full
    lane); ``page_cap`` is an absolute per-class cap."""

    def __init__(self, widths: Sequence[int], num_slots: int, page_size: int,
                 pool_frac: float = 1.0, page_cap: Optional[int] = None,
                 device: Optional[torch.device] = None):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        if not 0.0 < pool_frac <= 1.0:
            raise ValueError("pool_frac must be in (0, 1]")
        if page_cap is not None and page_cap <= 0:
            raise ValueError("page_cap must be positive when set")
        self.num_slots = num_slots
        self.page_size = page_size
        self.device = torch.device("cpu") if device is None else device
        self.classes: Dict[int, PageClass] = {}
        for w in sorted(set(int(w) for w in widths)):
            lane_pages = -(-w // page_size)
            num_pages = max(lane_pages,
                            int(np.ceil(pool_frac * num_slots * lane_pages)))
            if page_cap is not None:
                num_pages = min(num_pages, page_cap)
            self.classes[w] = PageClass(w, num_slots, page_size, num_pages)
        self._dev: Optional[Dict[int, torch.Tensor]] = None

    # -- capacity queries ----------------------------------------------

    @property
    def total_pages(self) -> int:
        return sum(c.num_pages for c in self.classes.values())

    def pages_in_use(self) -> int:
        return sum(c.num_pages - len(c.free) for c in self.classes.values())

    def free_page_budget(self) -> int:
        return sum(c.available() for c in self.classes.values())

    def memory_ratio(self) -> float:
        return self.pages_in_use() / max(self.total_pages, 1)

    def class_needs(self, n_tokens: int) -> Dict[int, int]:
        """Per-width-class page demand of a lane holding ``n_tokens``."""
        ps = self.page_size
        return {w: -(-min(n_tokens, c.width) // ps)
                for w, c in self.classes.items()}

    def pages_needed(self, n_tokens: int) -> int:
        return sum(self.class_needs(n_tokens).values())

    def can_alloc(self, n_tokens: int) -> bool:
        return all(need <= self.classes[w].available()
                   for w, need in self.class_needs(n_tokens).items())

    # -- allocation ----------------------------------------------------

    def _take(self, c: PageClass, slot: int, lp: int) -> None:
        pg = c.free.pop()
        c.table[slot, lp] = pg
        c.refcount[pg] = 1

    def alloc_prefix(self, slot: int, n_tokens: int) -> None:
        """Allocate the logical-prefix pages covering positions ``[0,
        min(n_tokens, width))`` in every class (mapped entries are kept).
        All-or-nothing: raises ``RuntimeError`` and allocates nothing if
        any class lacks free pages."""
        plan = []
        for c in self.classes.values():
            need = -(-min(n_tokens, c.width) // self.page_size)
            lps = [lp for lp in range(need) if c.table[slot, lp] == c.FREE]
            if len(lps) > c.available():
                raise RuntimeError(
                    f"page pool exhausted: class width={c.width} needs "
                    f"{len(lps)} pages, {c.available()} obtainable")
            plan.extend((c, lp) for lp in lps)
        for c, lp in plan:
            self._take(c, slot, lp)
        if plan:
            self._dev = None

    def ensure_write(self, slot: int, length: int) -> bool:
        """Make position ``length`` (mod each width) writable for ``slot``,
        allocating the page it lands on where missing. All-or-nothing:
        returns False, changing nothing, when any class is out of pages."""
        plan = []
        for c in self.classes.values():
            lp = (length % c.width) // self.page_size
            if c.table[slot, lp] == c.FREE:
                plan.append((c, lp))
        counts = Counter(id(c) for c, _ in plan)
        if any(counts[id(c)] > c.available() for c in self.classes.values()):
            return False
        for c, lp in plan:
            self._take(c, slot, lp)
        if plan:
            self._dev = None
        return True

    def make_range_writable(self, slot: int, start: int, end: int) -> None:
        """Check that every position in ``[start, end)`` of ``slot``'s lane
        is mapped (``alloc_prefix`` ran); raises ``RuntimeError`` otherwise.
        Without sharing no mapped page needs a copy before the write."""
        for c in self.classes.values():
            for lp in sorted({(p % c.width) // self.page_size
                              for p in range(start, end)}):
                if c.table[slot, lp] == c.FREE:
                    raise RuntimeError("write range not allocated")

    def release(self, slot: int) -> None:
        """Drop every reference ``slot`` holds; pages at refcount 0 return
        to the free list."""
        for c in self.classes.values():
            held = c.table[slot]
            for lp in np.flatnonzero(held != c.FREE):
                pg = int(held[lp])
                c.refcount[pg] -= 1
                if c.refcount[pg] == 0:
                    c.free.append(pg)
            held[:] = c.FREE
        self._dev = None

    def shuffle_free(self, rng: np.random.Generator) -> None:
        """Scramble physical page order (tests: output must not depend on
        fragmentation)."""
        for c in self.classes.values():
            rng.shuffle(c.free)

    # -- device views --------------------------------------------------

    def device_tables(self) -> Dict[int, torch.Tensor]:
        """``{width: (num_slots + 1, lane_pages) int32}`` block tables on
        the pool's device (sentinel row included), cached until the next
        mutation."""
        if self._dev is None:
            self._dev = {w: torch.from_numpy(c.table.copy()).to(self.device)
                         for w, c in self.classes.items()}
        return self._dev

    # -- invariants ----------------------------------------------------

    def check_invariants(self) -> None:
        """Refcounts equal block-table references, the sentinel row is all
        ``FREE``, and free/mapped partition the pool. Raises
        :class:`~repro_torch.core.errors.AuditError` naming the check."""
        for c in self.classes.values():
            if c.table[self.num_slots].tolist() != [c.FREE] * c.lane_pages:
                raise AuditError(
                    "sentinel-row", f"width={c.width}: sentinel block-table "
                    "row no longer all-FREE")
            mapped = c.table[:self.num_slots][
                c.table[:self.num_slots] != c.FREE]
            refs = Counter(mapped.tolist())
            for pg in range(c.num_pages):
                if c.refcount[pg] != refs.get(pg, 0):
                    raise AuditError(
                        "refcount-drift",
                        f"width={c.width} page {pg}: refcount "
                        f"{int(c.refcount[pg])} != {refs.get(pg, 0)} "
                        "block-table references")
            if len(set(c.free)) != len(c.free):
                raise AuditError("free-dup",
                                 f"width={c.width}: free list duplicated")
            if set(c.free) & set(refs):
                raise AuditError(
                    "free-mapped", f"width={c.width}: pages "
                    f"{sorted(set(c.free) & set(refs))} free AND mapped")
            if len(c.free) + len(refs) != c.num_pages:
                raise AuditError(
                    "page-leak", f"width={c.width}: free {len(c.free)} + "
                    f"mapped {len(refs)} != {c.num_pages} pool pages")
