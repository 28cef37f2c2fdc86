"""Public TDA ops over slot lanes (``repro.kernels.tda.ops``): bound
preparation, the paged addressing helpers, and the choice between the
kernel wrappers and the dense reference. Contiguous lanes go to the
kernel at their own width: the reference pads every lane to a multiple of
``block_k`` on every call, which would copy each layer's whole lane a
decode step; the kernel masks the ragged tail from the bounds instead."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.tda.ref import (
    decode_attention_reference,
    mixed_attention_reference,
)
from repro_torch.kernels.tda.tda import (
    tda_decode_attention,
    tda_mixed_attention,
    tda_paged_decode_attention,
)

__all__ = ["fused_decode_attention", "fused_mixed_attention",
           "gather_paged_lanes", "paged_flat_positions"]


def paged_flat_positions(block_table: torch.Tensor,
                         page_size: int) -> torch.Tensor:
    """``(R, n) -> (R, n * page_size)``: lane position ``p`` of row ``r``
    lives at flat pool position ``bt[r, p // page_size] * page_size + p %
    page_size``. ``FREE == num_pages`` entries land at ``>= num_pages *
    page_size``: gathers clamp them, writes drop them."""
    R, n = block_table.shape
    off = torch.arange(page_size, device=block_table.device)
    return (block_table.long()[:, :, None] * page_size
            + off[None, None, :]).reshape(R, n * page_size)


def gather_paged_lanes(pool: torch.Tensor,
                       block_table: torch.Tensor) -> torch.Tensor:
    """``(P, page_size, ...) + (B, n) -> (B, n * page_size, ...)`` lane
    views; sentinel entries clamp into range (their garbage sits beyond
    every valid bound)."""
    P, ps = pool.shape[0], pool.shape[1]
    flat = pool.reshape((P * ps,) + tuple(pool.shape[2:]))
    pos = torch.clamp(paged_flat_positions(block_table, ps), 0, P * ps - 1)
    return flat[pos]


def fused_decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, D) or (B, Hq, D)
    k: torch.Tensor,        # (B, S, Hkv, D) lanes or (P, ps, Hkv, D) pool
    v: torch.Tensor,
    lengths,                # scalar or (B,): valid lane depth per slot
    *,
    k_scale: Optional[torch.Tensor] = None,  # int8 codes' f32 scales
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    lut_table: Optional[torch.Tensor] = None,  # AFU exp LUT (else exact)
    block_k: int = 128,
    block_table: Optional[torch.Tensor] = None,  # (B, n): paged pool
    use_kernel: bool = True,
) -> torch.Tensor:
    """Length-predicated decode attention over contiguous lanes or, with
    ``block_table``, paged lanes: positions ``[max(0, lengths - window),
    lengths)`` are attended, slots with ``lengths <= 0`` return zeros.
    ``k``/``v`` are fp, or int8 codes with ``k_scale``/``v_scale`` (their
    shape without the last axis). ``lut_table`` routes the softmax's
    exponentials through the AFU's LUT, rescaled per block of
    ``min(block_k, S)`` positions (contiguous lanes) or per page (paged;
    ``block_k`` is ignored there). ``use_kernel=False`` runs the dense
    exact-exp oracle and ignores ``lut_table``, as the reference's does.
    Output has ``q``'s shape and dtype."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    if not use_kernel:
        lanes = [t if t is None or block_table is None
                 else gather_paged_lanes(t, block_table)
                 for t in (k, v, k_scale, v_scale)]
        out = decode_attention_reference(q, lanes[0], lanes[1], lengths,
                                         k_scale=lanes[2], v_scale=lanes[3],
                                         window=window)
    else:
        B = q.shape[0]
        S = k.shape[1] if block_table is None \
            else block_table.shape[1] * k.shape[1]  # logical lane width
        hi = torch.clamp(torch.as_tensor(lengths, device=q.device)
                         .reshape(-1).expand(B), 0, S)
        lo = torch.zeros_like(hi) if window is None \
            else torch.clamp(hi - window, min=0)
        bounds = torch.stack([lo, hi], dim=1).to(torch.int32)
        if block_table is None:
            out = tda_decode_attention(q.contiguous(), k, v, bounds,
                                       k_scale, v_scale, lut_table,
                                       block_k=block_k)
        else:
            out = tda_paged_decode_attention(
                q.contiguous(), k, v, bounds,
                block_table.to(torch.int32).contiguous(), k_scale, v_scale,
                lut_table)
    out = out.to(q.dtype)
    return out[:, None] if squeeze else out


def fused_mixed_attention(
    q: torch.Tensor,        # (B, S, Hq, D) chunk queries, left-aligned
    k: torch.Tensor,        # (P, page_size, Hkv, D) PRE-write page pool
    v: torch.Tensor,
    k_row: torch.Tensor,    # (B, S, Hkv, D) this chunk's fp keys
    v_row: torch.Tensor,
    cache_index,            # (B,)
    n_new,                  # (B,)
    *,
    block_table: torch.Tensor,
    ring: int,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # (P, page_size, Hkv)
    v_scale: Optional[torch.Tensor] = None,
    lut_table: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Mixed-step attention over paged lanes (masks pinned by
    :func:`~repro_torch.kernels.tda.ref.mixed_attention_reference`). The
    pool is fp, or int8 codes with ``k_scale``/``v_scale`` pools that
    follow the block table; ``lut_table`` routes the exponentials through
    the AFU's LUT (per page, then the row chunk). ``use_kernel=False`` runs
    the dense exact-exp oracle and ignores ``lut_table``, as the
    reference's does. Returns ``(B, S, Hq, D)`` in ``q.dtype``; only
    columns ``j < n_new`` are meaningful."""
    B = q.shape[0]
    ci = torch.as_tensor(cache_index, device=q.device).reshape(-1) \
        .to(torch.int32).expand(B)
    nn = torch.as_tensor(n_new, device=q.device).reshape(-1) \
        .to(torch.int32).expand(B)
    if not use_kernel:
        sc = [None if t is None else gather_paged_lanes(t, block_table)
              for t in (k_scale, v_scale)]
        out = mixed_attention_reference(
            q, gather_paged_lanes(k, block_table),
            gather_paged_lanes(v, block_table), k_row, v_row, ci, nn,
            ring=ring, window=window, k_scale=sc[0], v_scale=sc[1])
    else:
        bounds = torch.stack([ci, nn], dim=1).contiguous()
        out = tda_mixed_attention(
            q.contiguous(), k, v, k_row.contiguous(), v_row.contiguous(),
            bounds, block_table.to(torch.int32).contiguous(), k_scale,
            v_scale, lut_table, ring=ring, window=window)
    return out.to(q.dtype)
