"""Paged KV lane pool: block-table allocation for the slot table, with
page-level prefix sharing and copy-on-write (``repro.serve.pages``).

Each kv leaf is a pool of ``page_size``-token physical pages; each slot
holds an int32 block table mapping logical page ``i`` of its lane to a
physical page or the ``FREE`` sentinel. Lanes grow page by page and
release their pages, so pages in use track live tokens.

**Prefix sharing**, as the reference does it:

* every full page a lane holds is content-addressed by a chained digest
  of all prompt tokens up to the end of that page
  (:func:`prefix_digests`): a token's K/V depend on the whole prefix
  before it. ``publish_prefix`` registers a lane's full pages in the
  per-width-class index; ``probe_prefix`` returns the longest run of hits
  from logical page 0 (capped at ``len(prompt) - 1``, so the last token
  is always recomputed);
* ``map_shared`` points a new slot's block table at the hit pages and
  takes a reference on each (``refcount``); pages free at refcount 0;
* a page is never written while anyone else can see it: before a write,
  ``make_writable`` / ``make_range_writable`` **copy-on-write** pages with
  refcount > 1 into fresh pages (the caller runs the device copy,
  ``SlotKVCache.copy_pages``) and unpublish sole-owner pages still in the
  index;
* a published page whose last reference drops is **retained** in a
  per-class LRU instead of freed, so later requests (and preempted
  continuations) still hit it; allocation takes the free list first,
  then evicts retained pages LRU-first.

Layout invariants, the same as the reference's:

* logical lane coordinates are unchanged: token ``t`` lives at logical
  position ``t``; paging only remaps logical page ``t // page_size``;
* a slot's allocated pages are a logical prefix of its lane;
* ``FREE == num_pages``: a gather through it is clamped, a write through it
  dropped, so unallocated entries cost nothing;
* block tables carry one extra sentinel row (index ``num_slots``) that
  stays all-``FREE``.

:class:`FleetPrefixIndex` adds a cross-replica host tier: replicas mirror
the bytes of their published pages into it (``SlotKVCache.read_page``) and
restore pages another replica prefilled (``adopt_published`` +
``SlotKVCache.write_page``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.errors import AuditError

__all__ = ["FleetPrefixIndex", "PagePool", "PageClass", "PrefixHit",
           "prefix_digests"]

# (width, src_page, dst_page): a device-side page copy the caller owes the
# pool after a copy-on-write remap (SlotKVCache.copy_pages runs them).
PageCopy = Tuple[int, int, int]


def prefix_digests(tokens: np.ndarray, page_size: int,
                   n_pages: int) -> List[str]:
    """Chained per-page digests: entry ``lp`` hashes all tokens ``[0,
    (lp + 1) * page_size)`` (blake2b, 16 bytes, over the int32 bytes)."""
    h = hashlib.blake2b(digest_size=16)
    out: List[str] = []
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    for lp in range(n_pages):
        h.update(toks[lp * page_size:(lp + 1) * page_size].tobytes())
        out.append(h.hexdigest())
    return out


@dataclasses.dataclass
class PrefixHit:
    """A probe's result: the first ``n_shared`` prompt tokens are served by
    mapping ``pages[width]`` (physical page ids per width class)."""

    n_shared: int
    pages: Dict[int, List[int]]


class FleetPrefixIndex:
    """Cross-replica prefix index with a host-memory page tier.

    One instance is shared by N engine replicas (``serve/dispatch.py``
    wires it). A replica that publishes a prompt's full prefix pages
    locally also mirrors each page's bytes here (host numpy copies, one
    array per kv leaf in ``SlotKVCache.read_page`` order) under the local
    index's content address ``(width, logical_page, chained_digest)``; a
    replica probing a prompt that only another replica prefilled restores
    the missing pages into its own pool and then hits locally, so a hot
    system prompt is prefilled once per fleet. Pages stay restorable after
    local eviction while this index keeps them (LRU, bounded by
    ``capacity``). ``version`` is bumped on every store mutation: engines
    key their probe memo on it."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is not None and capacity <= 0:
            raise ValueError("capacity must be positive when set")
        self.capacity = capacity
        # (width, logical_page, digest) -> host page bytes (one np array
        # per kv leaf of the width class, in SlotKVCache.read_page order).
        self._store: "OrderedDict[Tuple[int, int, str], List[np.ndarray]]" \
            = OrderedDict()
        # Bumped on every store mutation: engines fold this into their
        # probe memo key so a fleet publish invalidates cached misses.
        self.version = 0
        self.published = 0
        self.hits = 0
        self.misses = 0
        self.restored_pages = 0

    def __len__(self) -> int:
        return len(self._store)

    def has(self, width: int, lp: int, digest: str) -> bool:
        return (width, lp, digest) in self._store

    def publish(self, width: int, lp: int, digest: str,
                host_page: List[np.ndarray]) -> None:
        """Mirror one page's bytes (first publisher wins — identical
        content by construction). LRU-evicts past ``capacity``."""
        key = (width, lp, digest)
        if key in self._store:
            return
        self._store[key] = host_page
        self.published += 1
        self.version += 1
        if self.capacity is not None:
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)

    def get(self, width: int, lp: int,
            digest: str) -> Optional[List[np.ndarray]]:
        key = (width, lp, digest)
        page = self._store.get(key)
        if page is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return page


class PageClass:
    """Bookkeeping for one lane width: free list, per-slot block table,
    per-page refcounts, the prefix index and the retained LRU."""

    def __init__(self, width: int, num_slots: int, page_size: int,
                 num_pages: int):
        self.width = width
        self.lane_pages = -(-width // page_size)
        self.num_pages = num_pages
        self.free: List[int] = list(range(num_pages))
        self.table = np.full((num_slots + 1, self.lane_pages), num_pages,
                             np.int32)
        self.refcount = np.zeros(num_pages, np.int32)
        # (logical_page, chained_digest) -> physical page, and back.
        self.index: Dict[Tuple[int, str], int] = {}
        self.published: Dict[int, Tuple[int, str]] = {}
        # refcount-0 published pages, oldest first
        self.retained: "OrderedDict[int, None]" = OrderedDict()

    @property
    def FREE(self) -> int:
        return self.num_pages

    def available(self) -> int:
        """Pages obtainable now: free plus evictable retained."""
        return len(self.free) + len(self.retained)


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
        # Bumped whenever the prefix index changes: a probe is a pure
        # function of the index, so callers memoize hits against it.
        self.prefix_version = 0

    # -- capacity queries ----------------------------------------------

    @property
    def total_pages(self) -> int:
        return sum(c.num_pages for c in self.classes.values())

    def pages_in_use(self) -> int:
        """Distinct pages mapped by at least one slot (retained pages are
        reclaimable cache, not footprint)."""
        return sum(c.num_pages - len(c.free) - len(c.retained)
                   for c in self.classes.values())

    def pages_shared(self) -> int:
        """Block-table references served by an already-mapped page."""
        return int(sum(np.maximum(c.refcount - 1, 0).sum()
                       for c in self.classes.values()))

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

    # -- prefix cache ---------------------------------------------------

    def probe_prefix(self, tokens: np.ndarray) -> Optional[PrefixHit]:
        """Longest shareable prefix of ``tokens`` resident now: per class
        the run of consecutive digest hits from page 0, the minimum over
        classes, capped at ``len(tokens) - 1``. A class whose lane the
        prompt would wrap cannot share. None on a miss."""
        L = len(tokens)
        ps = self.page_size
        m_max = L // ps
        if m_max == 0:
            return None
        digests = prefix_digests(tokens, ps, m_max)
        m = m_max
        for c in self.classes.values():
            if L > c.width:
                return None
            mc = 0
            while mc < m and (mc, digests[mc]) in c.index:
                mc += 1
            m = min(m, mc)
            if m == 0:
                return None
        n_shared = min(m * ps, L - 1)
        k = -(-n_shared // ps)  # mapped pages cover [0, n_shared)
        pages = {w: [c.index[(lp, digests[lp])] for lp in range(k)]
                 for w, c in self.classes.items()}
        return PrefixHit(n_shared=n_shared, pages=pages)

    def map_shared(self, slot: int, hit: PrefixHit) -> None:
        """Point ``slot``'s logical pages ``0..k-1`` at the hit pages and
        take a reference on each; a retained page leaves the LRU."""
        for w, page_list in hit.pages.items():
            c = self.classes[w]
            for lp, pg in enumerate(page_list):
                assert c.table[slot, lp] == c.FREE, "slot lane not empty"
                c.table[slot, lp] = pg
                if c.refcount[pg] == 0:
                    c.retained.pop(pg, None)
                c.refcount[pg] += 1
        if hit.pages:
            self._dev = None

    def publish_prefix(self, slot: int, tokens: np.ndarray) -> None:
        """Register ``slot``'s full pages (``lp < len // page_size``) in the
        prefix index; the first publisher of a key wins."""
        L = len(tokens)
        ps = self.page_size
        m = L // ps
        if m == 0:
            return
        digests = prefix_digests(tokens, ps, m)
        for c in self.classes.values():
            if L > c.width:
                continue  # a wrapped lane is not prefix-determined
            for lp in range(m):
                pg = int(c.table[slot, lp])
                if pg == c.FREE:
                    break
                key = (lp, digests[lp])
                if key in c.index or pg in c.published:
                    continue
                c.index[key] = pg
                c.published[pg] = key
                self.prefix_version += 1

    def adopt_published(self, width: int, lp: int,
                        digest: str) -> Optional[int]:
        """Take a page for an externally supplied prefix page and park it
        indexed and retained (refcount 0); the caller owes it its bytes.
        Returns the page (the resident one when the key is indexed), or
        None when the class has no obtainable page."""
        c = self.classes[width]
        key = (lp, digest)
        if key in c.index:
            return c.index[key]
        pg = self._take_page(c)
        if pg is None:
            return None
        c.index[key] = pg
        c.published[pg] = key
        c.retained[pg] = None
        c.retained.move_to_end(pg)
        self.prefix_version += 1
        return pg

    # -- allocation ----------------------------------------------------

    def _unpublish(self, c: PageClass, pg: int) -> None:
        key = c.published.pop(pg, None)
        if key is not None:
            c.index.pop(key, None)
            self.prefix_version += 1

    def _take_page(self, c: PageClass) -> Optional[int]:
        """A writable page: the free list first, then the LRU retained page
        (unpublished)."""
        if c.free:
            return c.free.pop()
        if c.retained:
            pg, _ = c.retained.popitem(last=False)
            self._unpublish(c, pg)
            return pg
        return None

    def alloc_prefix(self, slot: int, n_tokens: int) -> None:
        """Allocate the logical-prefix pages covering positions ``[0,
        min(n_tokens, width))`` in every class (mapped entries are kept).
        All-or-nothing: raises ``RuntimeError`` and allocates nothing if
        any class lacks obtainable pages."""
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
            pg = self._take_page(c)
            c.table[slot, lp] = pg
            c.refcount[pg] = 1
        if plan:
            self._dev = None

    def make_writable(self, slot: int,
                      length: int) -> Tuple[bool, List[PageCopy]]:
        """Make position ``length`` (mod each width) writable for ``slot``:
        allocate its page where missing, copy-on-write it where shared,
        unpublish it where it is the last reference. All-or-nothing:
        ``(False, [])``, changing nothing, when a class is out of pages;
        else ``(True, copies the caller must run)``."""
        plan = []  # (class, lp, shared source or None)
        for c in self.classes.values():
            lp = (length % c.width) // self.page_size
            entry = int(c.table[slot, lp])
            if entry == c.FREE:
                plan.append((c, lp, None))
            elif c.refcount[entry] > 1:
                plan.append((c, lp, entry))
        counts = Counter(id(c) for c, _, _ in plan)
        if any(counts[id(c)] > c.available() for c in self.classes.values()):
            return False, []
        copies: List[PageCopy] = []
        for c, lp, src in plan:
            pg = self._take_page(c)
            c.table[slot, lp] = pg
            c.refcount[pg] = 1
            if src is not None:
                c.refcount[src] -= 1  # still >= 1: someone else maps it
                copies.append((c.width, src, pg))
        for c in self.classes.values():
            entry = int(c.table[slot, (length % c.width) // self.page_size])
            if c.refcount[entry] == 1 and entry in c.published:
                self._unpublish(c, entry)
        if plan:
            self._dev = None
        return True, copies

    def ensure_write(self, slot: int, length: int) -> bool:
        """:meth:`make_writable` without the copy list (allocator tests;
        the engine must run the copies)."""
        return self.make_writable(slot, length)[0]

    def make_range_writable(self, slot: int, start: int,
                            end: int) -> List[PageCopy]:
        """Make every position in ``[start, end)`` writable: copy-on-write
        shared pages, unpublish sole-owner published ones. The pages must
        be mapped already (``RuntimeError`` otherwise). All-or-nothing: a
        ``RuntimeError`` (no page for a copy) changes nothing, so the
        caller may preempt and retry."""
        def lps_of(c):
            return sorted({(p % c.width) // self.page_size
                           for p in range(start, end)})

        plan = []  # (class, lp, shared page)
        need: Dict[int, int] = {}
        for c in self.classes.values():
            for lp in lps_of(c):
                entry = int(c.table[slot, lp])
                if entry == c.FREE:
                    raise RuntimeError("write range not allocated")
                if c.refcount[entry] > 1:
                    plan.append((c, lp, entry))
                    need[c.width] = need.get(c.width, 0) + 1
        for c in self.classes.values():
            if need.get(c.width, 0) > c.available():
                raise RuntimeError(
                    f"page pool exhausted: class width={c.width} needs "
                    f"{need[c.width]} pages for copy-on-write, "
                    f"{c.available()} obtainable")
        copies: List[PageCopy] = []
        for c, lp, entry in plan:
            pg = self._take_page(c)
            c.table[slot, lp] = pg
            c.refcount[pg] = 1
            c.refcount[entry] -= 1
            copies.append((c.width, entry, pg))
            self._dev = None
        for c in self.classes.values():
            for lp in lps_of(c):
                entry = int(c.table[slot, lp])
                if c.refcount[entry] == 1 and entry in c.published:
                    self._unpublish(c, entry)
        return copies

    def release(self, slot: int) -> None:
        """Drop every reference ``slot`` holds. Pages at refcount 0 return
        to the free list, or, when published, to the retained LRU."""
        for c in self.classes.values():
            held = c.table[slot]
            for lp in np.flatnonzero(held != c.FREE):
                pg = int(held[lp])
                c.refcount[pg] -= 1
                if c.refcount[pg] == 0:
                    if pg in c.published:
                        c.retained[pg] = None
                        c.retained.move_to_end(pg)
                    else:
                        c.free.append(pg)
            held[:] = c.FREE
        self._dev = None

    def drop_prefix_cache(self) -> None:
        """Unpublish everything and free every retained page."""
        for c in self.classes.values():
            for pg in list(c.retained):
                self._unpublish(c, pg)
                c.free.append(pg)
            c.retained.clear()
            for pg in list(c.published):
                self._unpublish(c, pg)

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

    def check_invariants(self, ranks: int = 1, rank: int = 0) -> None:
        """Refcounts equal block-table references, free / retained / mapped
        partition the pool, the sentinel row is all ``FREE`` and the prefix
        index is a bijection. Raises
        :class:`~repro_torch.core.errors.AuditError` naming the check.

        ``ranks > 1``: this pool is rank ``rank``'s view of a
        KV-head-sharded deployment. Every rank holds its head slice of the
        same physical pages through its own copy of the same block tables
        (page ownership is host metadata over partitioned bytes; N head
        slices of one page are one allocation, never N), so each rank
        checks its own view once and a failure names the rank. Whether the
        ranks' views agree is :meth:`digest`'s to show (the engine's audit
        compares it across the ranks)."""
        try:
            self._check_view()
        except AuditError as e:
            if ranks > 1:
                raise AuditError(
                    e.check, f"{e.detail} [rank {rank}/{ranks} view]")
            raise

    def digest(self) -> bytes:
        """8 bytes hashed from the pool's host metadata: every class's
        block table, refcounts, free list and retained LRU (both in
        order: they decide the next allocation) and prefix index. Ranks
        that took the same page decisions give the same bytes."""
        h = hashlib.blake2b(digest_size=8)
        for w in sorted(self.classes):
            c = self.classes[w]
            for a in (c.table, c.refcount, np.asarray(c.free, np.int64),
                      np.asarray(list(c.retained), np.int64)):
                h.update(repr(a.shape).encode())
                h.update(np.ascontiguousarray(a).tobytes())
            h.update(repr(sorted(c.index.items())).encode())
        return h.digest()

    def _check_view(self) -> None:
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
            free, retained = set(c.free), set(c.retained)
            if len(free) != len(c.free):
                raise AuditError("free-dup",
                                 f"width={c.width}: free list duplicated")
            for check, a, b in (("free-mapped", free, set(refs)),
                                ("retained-free", retained, free),
                                ("retained-mapped", retained, set(refs))):
                if a & b:
                    raise AuditError(check, f"width={c.width}: pages "
                                     f"{sorted(a & b)} in both")
            if retained - set(c.published):
                raise AuditError(
                    "retained-unpublished", f"width={c.width}: pages "
                    f"{sorted(retained - set(c.published))} retained but "
                    "not in the prefix index")
            if len(free) + len(retained) + len(refs) != c.num_pages:
                raise AuditError(
                    "page-leak", f"width={c.width}: free {len(free)} + "
                    f"retained {len(retained)} + mapped {len(refs)} != "
                    f"{c.num_pages} pool pages")
            if len(c.index) != len(c.published) or any(
                    c.published.get(pg) != key
                    for key, pg in c.index.items()):
                raise AuditError("index-bijection",
                                 f"width={c.width}: prefix index and "
                                 "published map disagree")

    def check_lane_bounds(self, slot: int, length: int) -> None:
        """One active slot's block tables against its occupancy: allocated
        entries form a logical prefix, in range, covering ``[0, length]``
        (this step's write included)."""
        ps = self.page_size
        for c in self.classes.values():
            held = c.table[slot]
            k = 0
            while k < c.lane_pages and held[k] != c.FREE:
                k += 1
            if not (held[k:] == c.FREE).all():
                raise AuditError(
                    "lane-prefix", f"slot {slot} width={c.width}: allocated "
                    "pages are not a logical prefix of the lane: "
                    f"{held.tolist()}")
            if ((held[:k] < 0) | (held[:k] >= c.num_pages)).any():
                raise AuditError(
                    "table-range", f"slot {slot} width={c.width}: physical "
                    f"page id out of range: {held[:k].tolist()}")
            need = -(-min(length + 1, c.width) // ps)
            if k < need:
                raise AuditError(
                    "lane-bounds", f"slot {slot} width={c.width}: occupancy "
                    f"[0, {length}) + next write needs {need} pages, lane "
                    f"holds {k}")

    def check_write_private(self, slot: int, length: int) -> None:
        """The copy-on-write postcondition for one active slot: the page
        its next write (position ``length``) lands in is mapped, held by
        this slot alone, and not in the prefix index."""
        for c in self.classes.values():
            lp = (length % c.width) // self.page_size
            pg = int(c.table[slot, lp])
            if pg == c.FREE:
                raise AuditError(
                    "write-unmapped", f"slot {slot} width={c.width}: write "
                    f"position {length} lands on unallocated logical page "
                    f"{lp}")
            if c.refcount[pg] != 1:
                raise AuditError(
                    "cow-write-shared", f"slot {slot} width={c.width}: "
                    f"write-target page {pg} has refcount "
                    f"{int(c.refcount[pg])} (must be exclusively owned)")
            if pg in c.published:
                raise AuditError(
                    "cow-write-published", f"slot {slot} width={c.width}: "
                    f"write-target page {pg} is still in the prefix index")
