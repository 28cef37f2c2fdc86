"""Slot table over paged KV lanes (``repro.serve.kv_slots``, the paged
attention-lane parts the mixed-step engine uses).

``num_slots`` independent lanes share one page pool per kv leaf: the
caches are ``{"k", "v"}`` tensors of shape ``(L, P, page_size, Hkv, D)`` in
the compute dtype, addressed through :class:`~repro_torch.serve.pages.PagePool`
block tables. A request claims a slot (``claim``), the mixed step writes
its prompt chunks straight into the lane, and ``advance``/``advance_n``
count what was written. ``release`` frees the slot and its pages.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.serve.pages import PagePool

__all__ = ["SlotKVCache"]


class SlotKVCache:
    """Fixed-capacity table of per-request paged KV lanes. ``lengths[s]``
    is the number of tokens request ``s`` has pushed through the model
    (the next write position)."""

    def __init__(self, model, num_slots: int, cache_len: int,
                 page_size: int, pool_frac: float = 1.0,
                 page_cap: Optional[int] = None):
        if num_slots <= 0 or cache_len <= 0:
            raise ValueError("num_slots and cache_len must be positive")
        cfg = model.cfg
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.page_size = page_size
        self.device = model.device
        self.specs = model.cache_lane_specs()
        self.width = model._block_ring("attn", cache_len)
        self.pool = PagePool([self.width], num_slots, page_size,
                             pool_frac=pool_frac, page_cap=page_cap,
                             device=self.device)
        P = self.pool.classes[self.width].num_pages
        shape = (cfg.n_layers, P, page_size, cfg.kv_heads, cfg.head_dim)
        self.caches = {name: torch.zeros(shape, dtype=cfg.compute_dtype,
                                         device=self.device)
                       for name in self.specs}
        self.active = np.zeros(num_slots, bool)
        self.lengths = np.zeros(num_slots, np.int32)
        self.request: List[Optional[Any]] = [None] * num_slots

    def free_slots(self) -> np.ndarray:
        return np.flatnonzero(~self.active)

    def utilization(self) -> float:
        return float(self.active.mean())

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
        self.pool.release(slot)
