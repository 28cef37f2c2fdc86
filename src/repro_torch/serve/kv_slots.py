"""Slot table over per-request KV lanes (``repro.serve.kv_slots``, the
attention-lane parts).

``num_slots`` lanes of ``cache_len`` tokens live either in **contiguous**
caches (``Model.init_cache(num_slots, cache_len)``: ``(L, num_slots,
cache_len, Hkv, D)`` leaves) or, with ``page_size``, in **page pools**
(``Model.init_cache(num_pages, page_size)``: ``(L, P, page_size, Hkv, D)``)
addressed through :class:`~repro_torch.serve.pages.PagePool` block
tables. int8 lanes (``kv_quant``) carry ``k_scale``/``v_scale`` leaves of
the same layout without the last axis, which move with their codes.

The mixed-step engine ``claim``\\ s a slot and writes prompt chunks straight
into its lane; the phase-serialized engine prefills admissions into a
fresh cache and ``assign_many`` copies every admitted request's segment
into its lane in one gather and scatter per leaf. ``advance``/``advance_n``
count what was written; ``release`` frees the slot (and its pages).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.errors import UnsupportedConfigError
from repro_torch.kernels.tda.ops import paged_flat_positions
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
        self.width = model._block_ring("attn", cache_len)
        self.pool: Optional[PagePool] = None
        if page_size is not None:
            self.pool = PagePool([self.width], num_slots, page_size,
                                 pool_frac=pool_frac, page_cap=page_cap,
                                 device=self.device)
            self.caches = model.init_cache(
                self.pool.classes[self.width].num_pages, page_size)
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
                      out_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Assignment j's segment out of ``src`` (L, R, W_src, ...) as a
        lane: position ``p`` holds row position ``starts[j] + p``, valid for
        ``p < min(lengths[j], width)`` (lanes hold whole sequences: no
        window, so no ring phase). Returns ``(lanes (L, J, out_width, ...)
        with zeros at invalid positions, valid (J, out_width))``."""
        wsrc = src.shape[2]
        p = torch.arange(out_width, device=src.device)
        valid = p[None, :] < torch.clamp(lengths, max=self.width)[:, None]
        idx = torch.clamp(starts[:, None] + p[None, :], 0, wsrc - 1)
        lanes = src[:, rows[:, None], idx]
        vshape = (1,) + tuple(valid.shape) + (1,) * (lanes.dim() - 3)
        lanes = torch.where(valid.reshape(vshape), lanes,
                            torch.zeros((), dtype=lanes.dtype,
                                        device=lanes.device))
        return lanes, valid

    def _copy_lane(self, src_caches, slots, rows, starts, lengths) -> None:
        """Contiguous lanes: overwrite lane ``slots[j]`` wholesale (zeros
        past the segment). Padding entries (``slot == num_slots``) are
        dropped."""
        keep = slots < self.num_slots
        for name, dst in self.caches.items():
            lanes, _ = self._gather_lanes(src_caches[name], rows, starts,
                                          lengths, self.cache_len)
            dst[:, slots[keep]] = lanes[:, keep].to(dst.dtype)

    def _copy_lane_paged(self, src_caches, slots, rows, starts,
                         lengths) -> None:
        """Paged lanes: lane position ``p`` of slot ``slots[j]`` lands at
        flat pool position ``bt[slot, p // page_size] * page_size + p %
        page_size``. Invalid positions, FREE entries and the all-FREE
        sentinel row that padding entries index fall out of bounds and are
        dropped."""
        ps = self.page_size
        bt = self.pool.device_tables()[self.width]  # sentinel row last
        W = bt.shape[1] * ps  # page-quantized width (tail never read)
        flat = paged_flat_positions(bt[slots.long()], ps)  # (J, W)
        for name, dst in self.caches.items():
            lanes, valid = self._gather_lanes(src_caches[name], rows, starts,
                                              lengths, W)
            P = dst.shape[1]
            pos = torch.where(valid, flat, P * ps)
            keep = (pos >= 0) & (pos < P * ps)
            dstf = dst.view((dst.shape[0], P * ps) + tuple(dst.shape[3:]))
            dstf[:, pos[keep]] = lanes[:, keep].to(dst.dtype)

    def assign_many(self, assignments: Sequence[Assignment],
                    src_caches: Dict[str, torch.Tensor]) -> None:
        """Claim several slots in one lane copy per leaf. ``assignments``
        are ``(slot, request, row, start, length)`` drawn from ONE prefill's
        contiguous ``src_caches`` (``(L, rows, width, ...)``); segment
        masking made each packed request's K/V what an unpacked prefill
        would give. A reassigned lane is overwritten: no state survives a
        release -> assign cycle. With paged lanes each slot first pages in
        its logical prefix one position past the prompt (the first decode
        write's page is then held, not just reserved); an exhausted pool
        rolls the whole round back and raises ``RuntimeError``."""
        if not assignments:
            return
        for a in assignments:
            if len(a) > 5 and a[5]:
                raise UnsupportedConfigError(
                    "offset assigns onto shared prefix pages come with "
                    "prefix sharing, a later slice of the port (ROADMAP "
                    "Queue 1 item 7)")
        norm = [tuple(a[:5]) for a in assignments]
        for slot, _, _, _, length in norm:
            if self.active[slot]:
                raise ValueError(f"slot {slot} is already occupied")
            if length > self.cache_len:
                raise ValueError(f"request length {length} exceeds "
                                 f"cache_len {self.cache_len}")
        slots = [a[0] for a in norm]
        if len(set(slots)) != len(slots):
            raise ValueError(f"duplicate slots in one admission: {slots}")
        if self.pool is not None:
            attempted = []
            try:
                for slot, _, _, _, length in norm:
                    attempted.append(slot)
                    self.pool.alloc_prefix(slot,
                                           min(length + 1, self.cache_len))
            except RuntimeError:
                for slot in attempted:
                    self.pool.release(slot)
                raise
        # Pad the round to a power of two, as the reference does to bound
        # its compiled shapes; padding entries scatter nowhere.
        J = 1 << (len(norm) - 1).bit_length()
        pad = J - len(norm)

        def col(i, fill):
            return torch.tensor([a[i] for a in norm] + [fill] * pad,
                                dtype=torch.int64, device=self.device)

        args = (col(0, self.num_slots), col(2, 0), col(3, 0), col(4, 0))
        if self.pool is not None:
            self._copy_lane_paged(src_caches, *args)
        else:
            self._copy_lane(src_caches, *args)
        for slot, request, _, _, length in norm:
            self.active[slot] = True
            self.lengths[slot] = length
            self.request[slot] = request

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
