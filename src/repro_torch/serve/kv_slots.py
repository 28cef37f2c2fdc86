"""Slot table over per-request cache lanes (``repro.serve.kv_slots``).

Every cache leaf is typed by its lane spec (``Model.cache_lane_specs``):

* ``"kv"`` leaves are per-token attention lanes, either **contiguous**
  (``Model.init_cache(num_slots, cache_len)``: ``(num_slots, width, Hkv,
  D)`` a layer) or, with ``page_size``, **page pools** ``(P, page_size,
  Hkv, D)`` addressed through :class:`~repro_torch.serve.pages.PagePool`
  block tables, one width class per lane width. A leaf's lane ``width``
  (``widths``) is ``cache_len``, or the ring of a windowed layer,
  ``min(window, cache_len)``: a request's last ``min(len, width)`` tokens
  sit in **canonical ring phase** (token ``t`` at lane position ``t %
  width``), the phase of decode's write pointer. int8 lanes (``kv_quant``)
  carry ``k_scale``/``v_scale`` leaves of the same layout without the last
  axis, which move with their codes.
* ``"state"`` leaves are fixed-shape recurrent states (SSD state, RG-LRU
  ``h``, conv taps), ``(num_slots, ...)``, never paged: an assignment
  copies a prefill row's whole state into the lane (the engine prefills a
  recurrent stack one request per row, right-aligned, so the row's end
  state is the request's), ``advance`` changes nothing in them, and a
  reassigned lane is overwritten whole.

``specs``, ``widths`` and ``caches`` follow the model's cache structure: a
uniform stack's flat ``{leaf: ...}`` with a leading L axis on every leaf,
a heterogeneous stack's ``{"layer_XX": {leaf: ...}}`` (widths 0 for state
leaves). The pool sees only the kv leaves' widths (recurrentgemma-2b: one
ring of ``min(2048, cache_len)``; mamba2-370m has none and is never
paged). ``width`` is the lane width when there is exactly one, else
None.

The mixed-step engine ``claim``\\ s a slot and writes prompt chunks straight
into its lane; the phase-serialized engine prefills admissions into a
fresh cache and ``assign_many`` copies every admitted request's segment
(or state) into its lane in one gather and scatter per leaf.
``advance``/``advance_n`` count what was written; ``release`` frees the
slot (and its pages).

Prefix sharing adds the device halves of the pool's bookkeeping:
``copy_pages`` runs the copy-on-write page copies, ``gather_prefix``
reads a shared prefix out of the pool for a suffix prefill, and an
``assign_many`` entry with an offset lands its suffix behind pages the
engine mapped from the prefix cache. All are plain indexing on the
cache's device. ``read_page`` / ``write_page`` move one page of every
leaf to host numpy and back, for the fleet's host tier.

On a tensor-parallel ``mesh`` every kv leaf holds this rank's ``Hkv / N``
heads of every lane and page (``launch.sharding.slot_cache_specs``): the
block tables, lengths and page ownership are the same host metadata on
every rank, and every gather, copy and copy-on-write above acts on the
rank's own head slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.tda.ops import paged_flat_positions
from repro_torch.models.layers import kv_dequantize
from repro_torch.serve.pages import PagePool

__all__ = ["SlotKVCache", "SlotStateTable"]

# (slot, request, row, start, length): one admitted request's lane copy
# from row ``row``, positions ``[start, start + length)`` of a prefill cache.
Assignment = Tuple[int, Any, int, int, int]


def _paths(tree, pre=()) -> List[Tuple[str, ...]]:
    """The leaf paths of a nested dict, in sorted key order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _paths(tree[k], pre + (k,))
        else:
            out.append(pre + (k,))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class SlotKVCache:
    """Fixed-capacity table of per-request cache lanes. ``lengths[s]`` is
    the number of tokens request ``s`` has pushed through the model (the
    next write position; for state lanes it only feeds positions)."""

    def __init__(self, model, num_slots: int, cache_len: int,
                 page_size: Optional[int] = None, pool_frac: float = 1.0,
                 page_cap: Optional[int] = None, mesh=None):
        if num_slots <= 0 or cache_len <= 0:
            raise ValueError("num_slots and cache_len must be positive")
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.page_size = page_size
        self.device = model.device
        self.specs = model.cache_lane_specs()
        self.widths = model.cache_lane_widths(cache_len)
        self.dtype = model.cfg.compute_dtype
        self._stacked = model.cfg.uniform_layers  # leaves carry an L axis
        self._paths = _paths(self.specs)
        self._kv = [p for p in self._paths if _get(self.specs, p) == "kv"]
        self.pages_copied = 0  # copy-on-write pages copied (copy_pages)
        kv_widths = sorted({_get(self.widths, p) for p in self._kv})
        self.width = kv_widths[0] if len(kv_widths) == 1 else None
        # Any recurrent "state" leaf (such stacks neither share nor page
        # their states).
        self.state_lanes = len(self._kv) < len(self._paths)
        # Each layer's kv lane width, for a paged step's ``pages``: one
        # value for a uniform stack, {layer: width or None} otherwise.
        if self._stacked:
            self.layer_widths = self.width
        else:
            self.layer_widths = {
                name: next((_get(self.widths, p) for p in self._kv
                            if p[0] == name), None)
                for name in self.specs}
        self.pool: Optional[PagePool] = None
        if page_size is not None and kv_widths:
            self.pool = PagePool(kv_widths, num_slots, page_size,
                                 pool_frac=pool_frac, page_cap=page_cap,
                                 device=self.device)
            # Leaf shapes and dtypes from a one-row, one-position cache:
            # kv leaves become pools of their class's pages, state leaves
            # per-slot states.
            tmpl = model.init_cache(1, 1, ring=False, mesh=mesh)
            ba = 1 if self._stacked else 0
            self.caches: Dict[str, Any] = {}
            for p in self._paths:
                leaf = _get(tmpl, p)
                lead, rest = tuple(leaf.shape[:ba]), tuple(leaf.shape[ba:])
                if p in self._kv:
                    P = self.pool.classes[_get(self.widths, p)].num_pages
                    shape = lead + (P, page_size) + rest[2:]
                else:
                    shape = lead + (num_slots,) + rest[1:]
                _set(self.caches, p, torch.zeros(shape, dtype=leaf.dtype,
                                                 device=self.device))
        else:
            self.caches = model.init_cache(num_slots, cache_len, mesh=mesh)
        self.active = np.zeros(num_slots, bool)
        self.lengths = np.zeros(num_slots, np.int32)
        self.request: List[Optional[Any]] = [None] * num_slots

    def _leaf(self, tree, path) -> torch.Tensor:
        """Leaf ``path`` of a cache tree as ``(L', rows, ...)``: a uniform
        stack's leaf as it is, a per-layer leaf behind a unit axis (a view:
        writes land in the leaf)."""
        t = _get(tree, path)
        return t if self._stacked else t.unsqueeze(0)

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

    def _copy_state(self, src_caches, path, slots, rows, keep) -> None:
        """A state leaf: slot ``slots[j]`` takes row ``rows[j]``'s whole
        state (padding entries dropped)."""
        dst = self._leaf(self.caches, path)
        src = self._leaf(src_caches, path)
        dst[:, slots[keep]] = src[:, rows[keep]].to(dst.dtype)

    def _copy_lane(self, src_caches, slots, rows, starts, lengths,
                   offs) -> None:
        """Contiguous lanes: overwrite lane ``slots[j]`` wholesale (zeros
        past the segment; offsets are always 0 here); state leaves take the
        row's state. Padding entries (``slot == num_slots``) are
        dropped."""
        keep = slots < self.num_slots
        for path in self._paths:
            if path not in self._kv:
                self._copy_state(src_caches, path, slots, rows, keep)
                continue
            dst = self._leaf(self.caches, path)
            w = _get(self.widths, path)
            lanes, _ = self._gather_lanes(self._leaf(src_caches, path), rows,
                                          starts, lengths, w, w)
            dst[:, slots[keep]] = lanes[:, keep].to(dst.dtype)

    def _copy_lane_paged(self, src_caches, slots, rows, starts, lengths,
                         offs) -> None:
        """Paged lanes: lane position ``p`` of slot ``slots[j]`` lands at
        flat pool position ``bt[slot, p // page_size] * page_size + p %
        page_size``. Invalid positions (below the offset too: shared pages
        stay byte-identical), FREE entries and the all-FREE sentinel row
        that padding entries index fall out of bounds and are dropped.
        State leaves are copied as in :meth:`_copy_lane`."""
        ps = self.page_size
        tables = self.pool.device_tables()  # sentinel row last
        keep_s = slots < self.num_slots
        for path in self._paths:
            if path not in self._kv:
                self._copy_state(src_caches, path, slots, rows, keep_s)
                continue
            dst = self._leaf(self.caches, path)
            w = _get(self.widths, path)
            bt = tables[w]
            W = bt.shape[1] * ps  # page-quantized width (tail never read)
            flat = paged_flat_positions(bt[slots.long()], ps)  # (J, W)
            lanes, valid = self._gather_lanes(self._leaf(src_caches, path),
                                              rows, starts, lengths, w, W,
                                              offs)
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

    def _class_leaves(self, width: int) -> List[Tuple[str, ...]]:
        """The kv leaves of one width class, in sorted path order."""
        return [p for p in self._kv if _get(self.widths, p) == width]

    def copy_pages(self, copies: Sequence[Tuple[int, int, int]]) -> None:
        """Run copy-on-write page copies: for each ``(width, src, dst)``,
        physical page ``src`` is duplicated into ``dst`` in every kv leaf
        of that width class (codes and scales move together), one gather
        and scatter per leaf and class for the whole list. Sources are
        shared pages and destinations fresh ones, so no copy reads
        another's destination."""
        if not copies:
            return
        for w in sorted({c[0] for c in copies}):
            src = torch.tensor([c[1] for c in copies if c[0] == w],
                               dtype=torch.int64, device=self.device)
            dst = torch.tensor([c[2] for c in copies if c[0] == w],
                               dtype=torch.int64, device=self.device)
            for path in self._class_leaves(w):
                leaf = self._leaf(self.caches, path)
                leaf[:, dst] = leaf[:, src]
        self.pages_copied += len(copies)

    def gather_prefix(self, page_ids: Dict[int, np.ndarray]):
        """Dense prefix K/V out of the page pool for a suffix prefill:
        ``page_ids[width]`` is an int32 ``(R, n_pages)`` array of physical
        pages, one prefix per row (``FREE`` padding is clamped to a page
        whose contents the prefill masks). Returns ``(k, v)`` of shape
        ``(L, R, n_pages * page_size, Hkv, D)`` in the compute dtype, int8
        lanes dequantized; for a heterogeneous stack, ``{layer: array}``
        each (sharing runs only on stacks whose every leaf is kv)."""
        def lanes(d, name, w):
            ids = torch.as_tensor(np.asarray(page_ids[w]), dtype=torch.int64,
                                  device=self.device)
            ids = torch.clamp(ids, 0, self.pool.classes[w].num_pages - 1)
            leaf = d[name] if self._stacked else d[name].unsqueeze(0)
            sh = leaf[:, ids].shape  # (L', R, n, ps, ...)
            out = leaf[:, ids].reshape(sh[:2] + (sh[2] * sh[3],) + sh[4:])
            return out if self._stacked else out[0]

        def block(d, wd):
            w = wd["k"]
            k, v = lanes(d, "k", w), lanes(d, "v", w)
            if "k_scale" in d:
                return (kv_dequantize(k, lanes(d, "k_scale", w), self.dtype),
                        kv_dequantize(v, lanes(d, "v_scale", w), self.dtype))
            return k.to(self.dtype), v.to(self.dtype)

        if self._stacked:
            return block(self.caches, self.widths)
        out_k, out_v = {}, {}
        for name, d in self.caches.items():
            out_k[name], out_v[name] = block(d, self.widths[name])
        return out_k, out_v

    # numpy has no bfloat16: such leaves travel as their int16 bit patterns
    _HOST_VIEW = {torch.bfloat16: torch.int16}

    def read_page(self, width: int, page: int) -> List[np.ndarray]:
        """Host copy of physical page ``page`` of every kv leaf of the
        width class (codes and int8 scales included), in sorted leaf-path
        order: the payload a
        :class:`~repro_torch.serve.pages.FleetPrefixIndex` publish
        mirrors. Bytes are copied verbatim (bf16 as its int16 bits), so a
        restore is bit-identical."""
        out = []
        for path in self._class_leaves(width):
            leaf = self._leaf(self.caches, path)[:, page]
            out.append(leaf.view(self._HOST_VIEW.get(leaf.dtype, leaf.dtype))
                       .cpu().numpy())
        return out

    def write_page(self, width: int, page: int,
                   host: Sequence[np.ndarray]) -> None:
        """Inverse of :meth:`read_page`: write host page bytes into physical
        page ``page`` of every kv leaf of the class (same order)."""
        for path, arr in zip(self._class_leaves(width), host, strict=True):
            leaf = self._leaf(self.caches, path)
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
        """One decoded token was written at ``lengths[slot]`` (state lanes
        were updated in place by the step)."""
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


# The reference's name for the generalized table (kv and state lanes).
SlotStateTable = SlotKVCache
