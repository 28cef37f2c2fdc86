"""Plain PyTorch oracle for the TDA attention (``repro.kernels.tda.ref``).

The same masks, the same f32 softmax and the same "rows with no key give
zeros" conventions as the reference's jnp oracle, written with torch ops.
These are the dense path's attention (``decode_attn="dense"``), the
kernel wrappers' path on CPU tensors and the oracle the kernels are held
against. ``block_stats`` is the host-side
blocks-visited accounting the engine reports.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

NEG_INF = -1e30

__all__ = ["decode_attention_reference", "mixed_attention_reference",
           "block_stats"]


def _rows(x, B: int, device) -> torch.Tensor:
    """Scalar or (B,) -> (B, 1) int64 tensor."""
    t = torch.as_tensor(x, device=device).reshape(-1, 1).to(torch.int64)
    return t.expand(B, 1) if t.shape[0] == 1 else t


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
    kf = k.float() if k_scale is None else k.float() * k_scale[..., None]
    vf = v.float() if v_scale is None else v.float() * v_scale[..., None]
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
) -> torch.Tensor:
    """Multi-query attention of the mixed (chunked-prefill) step: query
    column ``j`` attends the pre-write lane (slot ``r`` holds token
    ``p_r = ci-1 - ((ci-1-r) mod ring)``, valid iff ``p_r >= 0``) and the
    causal in-row chunk (``i <= j``, ``i < n_new``). Columns ``j >= n_new``
    are garbage the caller ignores; rows with no valid key at all return
    zeros. Returns f32 ``(B, S, Hq, D)``."""
    B, S, Hq, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    ci = _rows(cache_index, B, dev)
    nn = _rows(n_new, B, dev)
    cols = torch.arange(S, device=dev)
    p_q = ci + cols[None, :]                                    # (B, S)
    r = torch.arange(W, device=dev)
    p_r = (ci - 1) - torch.remainder(ci - 1 - r[None, :], ring)  # (B, W)
    cache_valid = ((p_r >= 0) & (r[None, :] < ring))[:, None, :] \
        .expand(B, S, W)
    row_valid = (cols[None, :, None] >= cols[None, None, :]) \
        & (cols[None, None, :] < nn[:, :, None])                # (B, S, S)
    if window is not None:
        cache_valid = cache_valid & (p_r[:, None, :]
                                     > (p_q[:, :, None] - window))
        row_valid = row_valid & ((cols[None, :, None]
                                  - cols[None, None, :]) < window)
    qg = q.float().reshape(B, S, Hkv, G, D)
    s_c = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    s_r = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_row.float()) / math.sqrt(D)
    s_c = torch.where(cache_valid[:, None, None], s_c, NEG_INF)
    s_r = torch.where(row_valid[:, None, None], s_r, NEG_INF)
    p = torch.softmax(torch.cat([s_c, s_r], dim=-1), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p[..., :W], v.float())
    o = o + torch.einsum("bhgqk,bkhd->bhgqd", p[..., W:], v_row.float())
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)
    dead = (ci <= 0) & (nn <= 0)                                 # (B, 1)
    return torch.where(dead[:, :, None, None], 0.0, o)


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
