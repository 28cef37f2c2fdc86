"""Slot table over per-request KV lanes (``repro.serve.kv_slots``, the
attention-lane parts).

``num_slots`` lanes live either in **contiguous** caches
(``Model.init_cache(num_slots, cache_len)``: ``(L, num_slots, width, Hkv,
D)`` leaves) or, with ``page_size``, in **page pools**
(``Model.init_cache(num_pages, page_size, ring=False)``: ``(L, P,
page_size, Hkv, D)``) addressed through
:class:`~repro_torch.serve.pages.PagePool` block tables. A leaf's lane
``width`` (``widths``) is ``cache_len``, or the ring of a sliding-window
stack, ``min(window, cache_len)``: a request's last ``min(len, width)``
tokens sit in **canonical ring phase** (token ``t`` at lane position ``t %
width``), the phase of decode's write pointer. int8 lanes (``kv_quant``)
carry ``k_scale``/``v_scale`` leaves of the same layout without the last
axis, which move with their codes.

The mixed-step engine ``claim``\\ s a slot and writes prompt chunks straight
into its lane; the phase-serialized engine prefills admissions into a
fresh cache and ``assign_many`` copies every admitted request's segment
into its lane in one gather and scatter per leaf. ``advance``/``advance_n``
count what was written; ``release`` frees the slot (and its pages).

Prefix sharing adds the device halves of the pool's bookkeeping:
``copy_pages`` runs the copy-on-write page copies, ``gather_prefix``
reads a shared prefix out of the pool for a suffix prefill, and an
``assign_many`` entry with an offset lands its suffix behind pages the
engine mapped from the prefix cache. All are plain indexing on the
cache's device. ``read_page`` / ``write_page`` move one page of every
leaf to host numpy and back, for the fleet's host tier.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.tda.ops import paged_flat_positions
from repro_torch.models.layers import kv_dequantize
from repro_torch.serve.pages import PagePool

__all__ = ["SlotKVCache"]

# (slot, request, row, start, length): one admitted request's lane copy
# from row ``row``, positions ``[start, start + length)`` of a prefill cache.
Assignment = Tuple[int, Any, int, int, int]


class SlotKVCache:
    """Fixed-capacity table of per-request KV lanes. ``lengths[s]`` is the
    number of tokens request ``s`` has pushed through the model (the next
    write position)."""

    def __init__(self, model, num_slots: int, cache_len: int,
                 page_size: Optional[int] = None, pool_frac: float = 1.0,
                 page_cap: Optional[int] = None):
        if num_slots <= 0 or cache_len <= 0:
            raise ValueError("num_slots and cache_len must be positive")
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.page_size = page_size
        self.device = model.device
        self.specs = model.cache_lane_specs()
        self.dtype = model.cfg.compute_dtype
        self.pages_copied = 0  # copy-on-write pages copied (copy_pages)
        # Per-leaf logical lane width: every leaf of a uniform stack is an
        # attention lane of the same ring, so the pool has one width class.
        self.widths = {name: model._block_ring("attn", cache_len)
                       for name in self.specs}
        self.width = next(iter(self.widths.values()))
        self.pool: Optional[PagePool] = None
        if page_size is not None:
            self.pool = PagePool(sorted(set(self.widths.values())), num_slots,
                                 page_size, pool_frac=pool_frac,
                                 page_cap=page_cap, device=self.device)
            self.caches = model.init_cache(
                self.pool.classes[self.width].num_pages, page_size,
                ring=False)
        else:
            self.caches = model.init_cache(num_slots, cache_len)
        self.active = np.zeros(num_slots, bool)
        self.lengths = np.zeros(num_slots, np.int32)
        self.request: List[Optional[Any]] = [None] * num_slots

    def free_slots(self) -> np.ndarray:
        return np.flatnonzero(~self.active)

    def utilization(self) -> float:
        return float(self.active.mean())

    # -- lane copies ---------------------------------------------------

    def _gather_lanes(self, src: torch.Tensor, rows, starts, lengths,
                      width: int, out_width: int, offs=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Assignment j's segment out of ``src`` (L, R, W_src, ...) in
        canonical ring phase: lane position ``p`` holds token ``base + ((p
        - base) % width)``, ``base = max(lengths[j] - width, 0)``, read from
        row position ``starts[j] + token - offs[j]``; valid for ``offs[j]
        <= p < min(lengths[j], width)`` (a lane no longer than ``width``
        holds token ``p`` at ``p``). With an offset, ``lengths`` is the
        lane's total depth and the row holds only the suffix ``[offs,
        lengths)``; positions below ``offs`` live in shared pages (sharing
        needs an unwrapped lane, so ``base`` is 0 there). Returns ``(lanes
        (L, J, out_width, ...) with zeros at invalid positions, valid (J,
        out_width))``."""
        wsrc = src.shape[2]
        if offs is None:
            offs = torch.zeros_like(lengths)
        p = torch.arange(out_width, device=src.device)
        base = torch.clamp(lengths - width, min=0)[:, None]
        tok = base + torch.remainder(p[None, :] - base, width)
        valid = (p[None, :] < torch.clamp(lengths, max=width)[:, None]) \
            & (p[None, :] >= offs[:, None])
        idx = torch.clamp(starts[:, None] + tok - offs[:, None], 0,
                          wsrc - 1)
        lanes = src[:, rows[:, None], idx]
        vshape = (1,) + tuple(valid.shape) + (1,) * (lanes.dim() - 3)
        lanes = torch.where(valid.reshape(vshape), lanes,
                            torch.zeros((), dtype=lanes.dtype,
                                        device=lanes.device))
        return lanes, valid

    def _copy_lane(self, src_caches, slots, rows, starts, lengths,
                   offs) -> None:
        """Contiguous lanes: overwrite lane ``slots[j]`` wholesale (zeros
        past the segment; offsets are always 0 here). Padding entries
        (``slot == num_slots``) are dropped."""
        keep = slots < self.num_slots
        for name, dst in self.caches.items():
            w = self.widths[name]
            lanes, _ = self._gather_lanes(src_caches[name], rows, starts,
                                          lengths, w, w)
            dst[:, slots[keep]] = lanes[:, keep].to(dst.dtype)

    def _copy_lane_paged(self, src_caches, slots, rows, starts, lengths,
                         offs) -> None:
        """Paged lanes: lane position ``p`` of slot ``slots[j]`` lands at
        flat pool position ``bt[slot, p // page_size] * page_size + p %
        page_size``. Invalid positions (below the offset too: shared pages
        stay byte-identical), FREE entries and the all-FREE sentinel row
        that padding entries index fall out of bounds and are dropped."""
        ps = self.page_size
        tables = self.pool.device_tables()  # sentinel row last
        for name, dst in self.caches.items():
            w = self.widths[name]
            bt = tables[w]
            W = bt.shape[1] * ps  # page-quantized width (tail never read)
            flat = paged_flat_positions(bt[slots.long()], ps)  # (J, W)
            lanes, valid = self._gather_lanes(src_caches[name], rows, starts,
                                              lengths, w, W, offs)
            P = dst.shape[1]
            pos = torch.where(valid, flat, P * ps)
            keep = (pos >= 0) & (pos < P * ps)
            dstf = dst.view((dst.shape[0], P * ps) + tuple(dst.shape[3:]))
            dstf[:, pos[keep]] = lanes[:, keep].to(dst.dtype)

    def assign_many(self, assignments: Sequence[Assignment],
                    src_caches: Dict[str, torch.Tensor]) -> None:
        """Claim several slots in one lane copy per leaf. ``assignments``
        are ``(slot, request, row, start, length)``, optionally ``+
        (offset,)``, drawn from ONE prefill's contiguous ``src_caches``
        (``(L, rows, width, ...)``); segment masking made each packed
        request's K/V what an unpacked prefill would give. A reassigned
        lane is overwritten: no state survives a release -> assign cycle.

        With paged lanes each slot first pages in its logical prefix one
        position past its sequence (the first decode write's page is then
        held, not just reserved); an exhausted pool rolls the whole round
        back and raises ``RuntimeError``. A nonzero ``offset`` (paged only)
        means lane positions ``[0, offset)`` are shared pages the engine
        mapped (``PagePool.map_shared``): the row holds only the suffix,
        the lane's depth becomes ``offset + length``, and shared pages in
        the write range ``[offset, offset + length]`` are copied on write
        first."""
        if not assignments:
            return
        norm = [(a[0], a[1], a[2], a[3], a[4], a[5] if len(a) > 5 else 0)
                for a in assignments]
        for slot, _, _, _, length, off in norm:
            if self.active[slot]:
                raise ValueError(f"slot {slot} is already occupied")
            if off and self.pool is None:
                raise ValueError("offset assigns require the paged layout")
            if off + length > self.cache_len:
                raise ValueError(f"request length {off + length} exceeds "
                                 f"cache_len {self.cache_len}")
        slots = [a[0] for a in norm]
        if len(set(slots)) != len(slots):
            raise ValueError(f"duplicate slots in one admission: {slots}")
        if self.pool is not None:
            attempted, copies = [], []
            try:
                for slot, _, _, _, length, off in norm:
                    total = off + length
                    attempted.append(slot)
                    self.pool.alloc_prefix(slot,
                                           min(total + 1, self.cache_len))
                    if off:
                        # the suffix scatter plus the first decode write
                        copies += self.pool.make_range_writable(
                            slot, off, total + 1)
            except RuntimeError:
                for slot in attempted:
                    self.pool.release(slot)
                raise
            self.copy_pages(copies)
        # Pad the round to a power of two, as the reference does to bound
        # its compiled shapes; padding entries scatter nowhere.
        J = 1 << (len(norm) - 1).bit_length()
        pad = J - len(norm)

        def col(vals, fill):
            return torch.tensor(list(vals) + [fill] * pad, dtype=torch.int64,
                                device=self.device)

        args = (col(slots, self.num_slots), col((a[2] for a in norm), 0),
                col((a[3] for a in norm), 0),
                col((a[4] + a[5] for a in norm), 0),
                col((a[5] for a in norm), 0))
        if self.pool is not None:
            self._copy_lane_paged(src_caches, *args)
        else:
            self._copy_lane(src_caches, *args)
        for slot, request, _, _, length, off in norm:
            self.active[slot] = True
            self.lengths[slot] = off + length
            self.request[slot] = request

    # -- prefix-sharing device helpers ---------------------------------

    def copy_pages(self, copies: Sequence[Tuple[int, int, int]]) -> None:
        """Run copy-on-write page copies: for each ``(width, src, dst)``,
        physical page ``src`` is duplicated into ``dst`` in every kv leaf
        (codes and scales move together), one gather and scatter per leaf
        for the whole list. Sources are shared pages and destinations fresh
        ones, so no copy reads another's destination."""
        if not copies:
            return
        assert all(w == self.width for w, _, _ in copies), copies
        src = torch.tensor([c[1] for c in copies], dtype=torch.int64,
                           device=self.device)
        dst = torch.tensor([c[2] for c in copies], dtype=torch.int64,
                           device=self.device)
        for leaf in self.caches.values():
            leaf[:, dst] = leaf[:, src]
        self.pages_copied += len(copies)

    def gather_prefix(self, page_ids: Dict[int, np.ndarray]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense prefix K/V out of the page pool for a suffix prefill:
        ``page_ids[width]`` is an int32 ``(R, n_pages)`` array of physical
        pages, one prefix per row (``FREE`` padding is clamped to a page
        whose contents the prefill masks). Returns ``(k, v)`` of shape
        ``(L, R, n_pages * page_size, Hkv, D)`` in the compute dtype, int8
        lanes dequantized."""
        ids = torch.as_tensor(np.asarray(page_ids[self.width]),
                              dtype=torch.int64, device=self.device)
        ids = torch.clamp(ids, 0, self.pool.classes[self.width].num_pages - 1)

        def lanes(name):
            leaf = self.caches[name][:, ids]  # (L, R, n, ps, ...)
            sh = leaf.shape
            return leaf.reshape(sh[:2] + (sh[2] * sh[3],) + sh[4:])

        k, v = lanes("k"), lanes("v")
        if "k_scale" in self.caches:
            return (kv_dequantize(k, lanes("k_scale"), self.dtype),
                    kv_dequantize(v, lanes("v_scale"), self.dtype))
        return k.to(self.dtype), v.to(self.dtype)

    # numpy has no bfloat16: such leaves travel as their int16 bit patterns
    _HOST_VIEW = {torch.bfloat16: torch.int16}

    def read_page(self, width: int, page: int) -> List[np.ndarray]:
        """Host copy of physical page ``page`` of every kv leaf (codes and
        int8 scales included), in sorted leaf-name order: the payload a
        :class:`~repro_torch.serve.pages.FleetPrefixIndex` publish
        mirrors. Bytes are copied verbatim (bf16 as its int16 bits), so a
        restore is bit-identical."""
        assert width == self.width, (width, self.width)
        out = []
        for name in sorted(self.caches):
            leaf = self.caches[name][:, page]
            out.append(leaf.view(self._HOST_VIEW.get(leaf.dtype, leaf.dtype))
                       .cpu().numpy())
        return out

    def write_page(self, width: int, page: int,
                   host: Sequence[np.ndarray]) -> None:
        """Inverse of :meth:`read_page`: write host page bytes into physical
        page ``page`` of every kv leaf (same order)."""
        assert width == self.width, (width, self.width)
        for name, arr in zip(sorted(self.caches), host, strict=True):
            leaf = self.caches[name]
            leaf[:, page] = torch.from_numpy(np.asarray(arr)).to(
                self.device).view(leaf.dtype)

    def assign(self, slot: int, request, src_caches, row: int, start: int,
               length: int) -> None:
        """Claim ``slot`` for ``request`` and copy the segment
        ``src_caches[:, row, start:start + length]`` into its lane."""
        self.assign_many([(slot, request, row, start, length)], src_caches)

    # -- slot lifecycle ------------------------------------------------

    def claim(self, slot: int, request, length: int = 0) -> None:
        """Claim ``slot`` for ``request`` with ``length`` tokens already
        resident (0 for a cold admission); no lane state is copied."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is already occupied")
        if length > self.cache_len:
            raise ValueError(f"claim length {length} exceeds cache_len "
                             f"{self.cache_len}")
        self.active[slot] = True
        self.lengths[slot] = length
        self.request[slot] = request

    def advance(self, slot: int) -> None:
        """One decoded token was written at ``lengths[slot]``."""
        self.lengths[slot] += 1

    def advance_n(self, slot: int, n: int) -> None:
        """``n`` chunk tokens were written at ``[lengths, lengths + n)``."""
        self.lengths[slot] += n

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self.lengths[slot] = 0
        self.request[slot] = None
        if self.pool is not None:
            self.pool.release(slot)
