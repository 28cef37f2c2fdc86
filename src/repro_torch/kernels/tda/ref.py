"""Plain PyTorch oracle for the TDA attention (``repro.kernels.tda.ref``).

The same masks, the same f32 softmax and the same "rows with no key give
zeros" conventions as the reference's jnp oracle, written with torch ops.
These are the dense path's attention (``decode_attn="dense"``), the
kernel wrappers' path on CPU tensors and the oracle the kernels are held
against. ``block_stats`` is the host-side
blocks-visited accounting the engine reports.

``decode_attention_lut`` and ``mixed_attention_lut`` are the plain versions
of the kernels' LUT-exp mode, which the reference has only as its Pallas
kernels' body (``tda.py::_tda_body``, ``_tda_mixed_kernel``): under the
AFU's LUT exp, ``lut(a) * lut(b) != lut(a + b)``, so the result depends on
where the running max is rescaled, and these run the kernels' own
recurrence block by block over the same blocks (a Python loop over blocks,
vectorised over slots and heads).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.afu.ref import lut_exp

NEG_INF = -1e30

__all__ = ["decode_attention_reference", "mixed_attention_reference",
           "decode_attention_lut", "mixed_attention_lut", "block_stats"]


def _rows(x, B: int, device) -> torch.Tensor:
    """Scalar or (B,) -> (B, 1) int64 tensor."""
    t = torch.as_tensor(x, device=device).reshape(-1, 1).to(torch.int64)
    return t.expand(B, 1) if t.shape[0] == 1 else t


def _dequant(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 values: int8 codes times their per-(token, head) scales."""
    return x.float() if scale is None else x.float() * scale[..., None]


def decode_attention_reference(
    q: torch.Tensor,  # (B, Hq, D) or (B, 1, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    lengths,          # scalar or (B,): valid positions are [lo, lengths)
    *,
    k_scale: Optional[torch.Tensor] = None,  # (B, S, Hkv) when k is int8
    v_scale: Optional[torch.Tensor] = None,
    window=None,      # None, scalar or (B,): lo = lengths - window
) -> torch.Tensor:
    """Dense decode attention; masked softmax over every cache position.
    int8 codes (``k_scale``/``v_scale`` given) are dequantized in f32 first.
    Rows with ``lengths <= 0`` return zeros. Returns f32."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, D)
    kf, vf = _dequant(k, k_scale), _dequant(v, v_scale)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kf) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    hi = _rows(lengths, B, q.device)
    valid = pos[None, :] < hi
    if window is not None:
        valid &= pos[None, :] >= (hi - _rows(window, B, q.device))
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, vf)
    o = torch.where(hi > 0, o.reshape(B, Hq * D), 0.0).reshape(B, Hq, D)
    return o[:, None] if squeeze else o


def _mixed_masks(ci, nn, S: int, W: int, ring: int,
                 window: Optional[int]):
    """(B, S, W) cache and (B, S, S) in-row masks of the mixed step."""
    dev = ci.device
    cols = torch.arange(S, device=dev)
    p_q = ci + cols[None, :]                                    # (B, S)
    r = torch.arange(W, device=dev)
    p_r = (ci - 1) - torch.remainder(ci - 1 - r[None, :], ring)  # (B, W)
    cache_valid = ((p_r >= 0) & (r[None, :] < ring))[:, None, :] \
        .expand(ci.shape[0], S, W)
    row_valid = (cols[None, :, None] >= cols[None, None, :]) \
        & (cols[None, None, :] < nn[:, :, None])                # (B, S, S)
    if window is not None:
        cache_valid = cache_valid & (p_r[:, None, :]
                                     > (p_q[:, :, None] - window))
        row_valid = row_valid & ((cols[None, :, None]
                                  - cols[None, None, :]) < window)
    return cache_valid, row_valid


def mixed_attention_reference(
    q: torch.Tensor,      # (B, S, Hq, D) chunk queries, left-aligned
    k: torch.Tensor,      # (B, W, Hkv, D) PRE-write lane view
    v: torch.Tensor,
    k_row: torch.Tensor,  # (B, S, Hkv, D) this chunk's own keys
    v_row: torch.Tensor,
    cache_index,          # (B,): tokens already resident in the lane
    n_new,                # (B,): valid chunk columns, in [0, S]
    *,
    ring: int,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # (B, W, Hkv) when k is int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-query attention of the mixed (chunked-prefill) step: query
    column ``j`` attends the pre-write lane (slot ``r`` holds token
    ``p_r = ci-1 - ((ci-1-r) mod ring)``, valid iff ``p_r >= 0``) and the
    causal in-row chunk (``i <= j``, ``i < n_new``). int8 lane codes
    (``k_scale``/``v_scale`` given) are dequantized in f32 first; the chunk
    is fp. Columns ``j >= n_new`` are garbage the caller ignores; rows with
    no valid key at all return zeros. Returns f32 ``(B, S, Hq, D)``."""
    B, S, Hq, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    ci = _rows(cache_index, B, dev)
    nn = _rows(n_new, B, dev)
    cache_valid, row_valid = _mixed_masks(ci, nn, S, W, ring, window)
    qg = q.float().reshape(B, S, Hkv, G, D)
    kf, vf = _dequant(k, k_scale), _dequant(v, v_scale)
    s_c = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) / math.sqrt(D)
    s_r = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_row.float()) / math.sqrt(D)
    s_c = torch.where(cache_valid[:, None, None], s_c, NEG_INF)
    s_r = torch.where(row_valid[:, None, None], s_r, NEG_INF)
    p = torch.softmax(torch.cat([s_c, s_r], dim=-1), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p[..., :W], vf)
    o = o + torch.einsum("bhgqk,bkhd->bhgqd", p[..., W:], v_row.float())
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)
    dead = (ci <= 0) & (nn <= 0)                                 # (B, 1)
    return torch.where(dead[:, :, None, None], 0.0, o)


class _LutSoftmax:
    """Running (m, l, o) of the LUT-exp online softmax over query rows of
    shape ``rows`` (per slot, kv head, ...), one block at a time, as the
    reference kernels' body does it: per visited block ``m_new = max(m,
    max of masked s)``, ``p = where(valid, lut(s - m_new), 0)``, ``alpha =
    lut(m - m_new)``, ``l = l * alpha + sum(p)``, ``o = o * alpha + p @ v``;
    at the end ``o / max(l, 1e-30)``."""

    def __init__(self, rows, D: int, table: torch.Tensor):
        dev = table.device
        self.table = table
        self.m = torch.full(rows, NEG_INF, device=dev)
        self.l = torch.zeros(rows, device=dev)
        self.o = torch.zeros(tuple(rows) + (D,), device=dev)

    def block(self, s, valid, pv, visit) -> None:
        """s (*rows, n) scores, valid broadcastable to s, pv(p) -> p @ v of
        shape (*rows, D), visit (B,) whether each slot visits the block."""
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(self.m, s.max(-1).values)
        p = torch.where(valid, lut_exp(s - m_new[..., None], self.table), 0.0)
        alpha = lut_exp(self.m - m_new, self.table)
        vis = visit.reshape((-1,) + (1,) * (self.m.dim() - 1))
        self.l = torch.where(vis, self.l * alpha + p.sum(-1), self.l)
        self.o = torch.where(vis[..., None],
                             self.o * alpha[..., None] + pv(p), self.o)
        self.m = torch.where(vis, m_new, self.m)

    def result(self) -> torch.Tensor:
        return self.o / torch.clamp(self.l, min=1e-30)[..., None]


def decode_attention_lut(
    q: torch.Tensor,       # (B, Hq, D)
    k: torch.Tensor,       # (B, S, Hkv, D) fp, or int8 codes with k_scale
    v: torch.Tensor,
    bounds: torch.Tensor,  # (B, 2) [lo, hi)
    table: torch.Tensor,   # (LUT_SIZE,) f32
    block_k: int,
    k_scale: Optional[torch.Tensor] = None,  # (B, S, Hkv)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention with the LUT exp over ``[lo, hi)`` (``hi`` clamped
    to S), in blocks of ``bk = min(block_k, S)`` positions aligned at
    multiples of ``bk`` (the reference's padded lane), each visited when
    it meets ``[lo, hi)``. Rows with ``hi <= lo`` return zeros. Paged lanes
    gathered into (B, n * page_size, ...) use ``block_k = page_size``: one
    page a block. Returns f32 (B, Hq, D)."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bk = min(block_k, max(S, 1))
    lo = bounds[:, 0:1].long().clamp(min=0)
    hi = bounds[:, 1:2].long().clamp(max=S)
    qg = q.float().reshape(B, Hkv, G, D)
    kf, vf = _dequant(k, k_scale), _dequant(v, v_scale)
    sm = _LutSoftmax((B, Hkv, G), D, table)
    for blk0 in range(0, S, bk):
        blk = slice(blk0, min(blk0 + bk, S))
        pos = torch.arange(blk.start, blk.stop, device=q.device)
        valid = (pos[None] >= lo) & (pos[None] < hi)            # (B, n)
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kf[:, blk]) \
            * (1.0 / math.sqrt(D))
        sm.block(s, valid[:, None, None],
                 lambda p: torch.einsum("bhgk,bkhd->bhgd", p, vf[:, blk]),
                 ((blk0 < hi) & (blk0 + bk > lo))[:, 0])
    return sm.result().reshape(B, Hq, D)


def mixed_attention_lut(
    q: torch.Tensor,      # (B, S, Hq, D)
    k: torch.Tensor,      # (B, W, Hkv, D) PRE-write lanes (gathered pages)
    v: torch.Tensor,
    k_row: torch.Tensor,  # (B, S, Hkv, D)
    v_row: torch.Tensor,
    cache_index,
    n_new,
    *,
    page_size: int,
    ring: int,
    window: Optional[int] = None,
    table: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # (B, W, Hkv) when k is int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mixed-step attention (masks of :func:`mixed_attention_reference`)
    with the LUT exp: the lane's pages in logical order are blocks, each
    visited when it starts below ``min(ci, ring)``, then the row's chunk is
    one block of S keys, visited when ``n_new > 0``. Rows with no visited
    key return zeros. Returns f32 (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    ci = _rows(cache_index, B, dev)
    nn = _rows(n_new, B, dev)
    cache_valid, row_valid = _mixed_masks(ci, nn, S, W, ring, window)
    qg = q.float().reshape(B, S, Hkv, G, D)
    kf, vf = _dequant(k, k_scale), _dequant(v, v_scale)
    inv = 1.0 / math.sqrt(D)
    sm = _LutSoftmax((B, Hkv, G, S), D, table)
    hi = torch.clamp(ci, max=ring)
    for blk0 in range(0, W, page_size):
        blk = slice(blk0, min(blk0 + page_size, W))
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf[:, blk]) * inv
        sm.block(s, cache_valid[:, None, None, :, blk],
                 lambda p: torch.einsum("bhgqk,bkhd->bhgqd", p, vf[:, blk]),
                 (blk0 < hi)[:, 0])
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_row.float()) * inv
    sm.block(s, row_valid[:, None, None],
             lambda p: torch.einsum("bhgqk,bkhd->bhgqd", p, v_row.float()),
             (nn > 0)[:, 0])
    return sm.result().permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)


def block_stats(lengths, cache_len: int, block_k: int,
                *, window: Optional[int] = None,
                batch: Optional[int] = None) -> Dict[str, float]:
    """Predicated-grid work accounting (host-side, numpy): ``visited``
    counts (slot, kv-block) pairs whose block meets the slot's ``[lo, hi)``
    span; ``dense`` is the unpredicated ``B * ceil(cache_len/bk)`` sweep."""
    lens = np.atleast_1d(np.asarray(lengths, np.int64))
    if batch is not None and lens.size == 1:
        lens = np.full(batch, lens[0])
    nk = -(-cache_len // block_k)
    hi = np.clip(lens, 0, cache_len)
    lo = np.zeros_like(hi) if window is None else np.maximum(hi - window, 0)
    first = lo // block_k
    last = -(-hi // block_k)
    visited = int(np.maximum(last - first, 0).sum())
    dense = int(lens.size * nk)
    return {"visited": visited, "dense": dense,
            "ratio": visited / max(dense, 1)}
