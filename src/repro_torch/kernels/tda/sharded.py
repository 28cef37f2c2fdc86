"""Decode attention as partials + merge (``repro.kernels.tda.sharded``).

The plain oracle of the decode kernels' split path (flash-decoding): each
split of the key axis computes *unnormalized* online-softmax partials

    ``acc = sum_j exp(s_j - m) * v_j``   (B, H, D) f32
    ``m   = max_j s_j``                  (B, H)    f32  (NEG_INF if empty)
    ``l   = sum_j exp(s_j - m)``         (B, H)    f32  (0 if empty)

over the keys it owns, and the output is ``m* = max m``, ``l* = sum l
exp(m - m*)``, ``o = sum acc exp(m - m*) / max(l*, eps)``. The empty
partial is exactly ``(0, NEG_INF, 0)``: its rescale ``exp(NEG_INF - m*)``
is exactly 0 when another split saw a key, and when none did the merge
gives ``0 / eps = 0``, the zeros of a never-attended slot. The CUDA decode
kernels (``kernels/csrc/tda_decode_body.cuh``) merge their splits by the
same formula, in split order. Written with torch ops.

:func:`sharded_decode_attention` is the tensor-parallel form, with the
reference's contract: K/V lanes cut on the **KV-head** axis over the
mesh's ``model`` axis go in, the replicated ``(B, 1, Hq, D)`` comes out.
Each rank computes the partials of its block of heads, scatters them
into full-width buffers whose other rows are the empty partial, and one
``all_reduce(MAX)`` and two ``all_reduce(SUM)`` merge them. A rank holds
every position of its heads, so each head's softmax is complete on its
owner and the merge is exact: the owner's rescale is ``exp(0) = 1`` and
every other rank adds a structural zero. So on a CUDA device the rank's
partials come from the port's decode kernel on its heads (contiguous or
paged lanes, fp or int8): the kernel's normalized row is the owner's
exact output, and the code supplies it as ``acc = o`` with ``m = 0``,
``l = 1`` (the empty partial for a row that attends nothing). On the CPU
they come from :func:`decode_partials`. The serving path itself does not
need the merge: its row-parallel output projection takes each rank's own
heads (``models/layers.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.tda.ops import (fused_decode_attention,
                                         gather_paged_lanes)
from repro_torch.kernels.tda.ref import NEG_INF, _dequant, _rows

__all__ = ["decode_partials", "merge_partials", "sharded_decode_attention",
           "check_head_split"]

_EPS = 1e-30  # the kernels' finish division guard


def decode_partials(
    q: torch.Tensor,        # (B, Hq, D)
    k: torch.Tensor,        # (B, S_loc, Hkv, D) fp, or int8 codes
    v: torch.Tensor,
    lengths,                # scalar or (B,): GLOBAL hi bound (pos < hi)
    *,
    k_scale: Optional[torch.Tensor] = None,  # (B, S_loc, Hkv)
    v_scale: Optional[torch.Tensor] = None,
    window=None,            # None, scalar or (B,): pos >= hi - window
    pos_offset: int = 0,    # global position of k[:, 0]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online-softmax partials over the local keys ``[pos_offset,
    pos_offset + S_loc)``: scores at ``1/sqrt(D)``, masked to ``NEG_INF``
    outside ``[hi - window, hi)``, the softmax left unnormalized. Returns
    ``(acc (B, Hq, D), m (B, Hq), l (B, Hq))`` in f32; a row whose span
    misses the local keys gives exactly ``(0, NEG_INF, 0)``."""
    kf, vf = _dequant(k, k_scale), _dequant(v, v_scale)
    B, S, Hkv, D = kf.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kf) * (1.0 / math.sqrt(D))
    pos = pos_offset + torch.arange(S, device=q.device)
    hi = _rows(lengths, B, q.device)
    valid = pos[None, :] < hi
    if window is not None:
        valid &= pos[None, :] >= (hi - _rows(window, B, q.device))
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.max(dim=-1).values if S else torch.full(
        (B, Hkv, G), NEG_INF, device=q.device)
    # exp(s - m) would be 1 on fully masked rows: gate on the mask itself.
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, vf)
    return acc.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


def merge_partials(acc: torch.Tensor,  # (R, B, H, D) f32
                   m: torch.Tensor,    # (R, B, H) f32
                   l: torch.Tensor,    # (R, B, H) f32
                   ) -> torch.Tensor:
    """Merge stacked partials into the normalized output (B, H, D): ``m* =
    max_r m``, rescale each partial by ``exp(m - m*)``, sum, divide by
    ``max(l*, eps)``. All-empty rows give exactly 0."""
    m_star = m.max(dim=0).values
    scale = torch.exp(m - m_star[None])
    l_star = (l * scale).sum(0)
    o = (acc * scale[..., None]).sum(0)
    return o / torch.clamp(l_star, min=_EPS)[..., None]


def check_head_split(n_kv: int, n_q: int, tp: int,
                     axis: str = "model") -> None:
    """The reference's refusal (``repro.kernels.tda.sharded``): decode
    attention splits whole kv heads and query heads over the ``axis``
    mesh axis, so both counts must divide by its size."""
    if n_kv % tp or n_q % tp:
        raise ValueError(
            f"kv_heads={n_kv} / n_heads={n_q} not divisible by the "
            f"{tp}-way '{axis}' mesh axis")


def sharded_decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, D), replicated
    k_cache: torch.Tensor,  # this rank's heads: (B, S, Hkv/N, D) lanes or
    v_cache: torch.Tensor,  # (P, page_size, Hkv/N, D) pools (block_table)
    cache_index,            # scalar or (B,): valid positions < cache_index
    *,
    mesh,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # int8 codes' f32 scales
    v_scale: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,  # (B, n) paged lanes
) -> torch.Tensor:
    """Tensor-parallel decode attention: KV-head-sharded caches in,
    replicated ``(B, 1, Hq, D)`` out. The rank's query heads are its
    contiguous block ``Hq / N`` (GQA groups follow their kv head); its
    partials (the decode kernel's rows on a CUDA ``q``,
    :func:`decode_partials` on the CPU) are merged across the ``model``
    axis by one ``all_reduce(MAX)`` and two ``all_reduce(SUM)``. A slot
    that attends nothing gives exactly 0. Refuses, with the reference's
    message (:func:`check_head_split`), head counts the axis does not
    divide."""
    B, _, Hq, D = q.shape
    tp = mesh.shape["model"]
    check_head_split(k_cache.shape[-2] * tp, Hq, tp)
    hq = Hq // tp
    r = mesh.coords["model"]
    q_loc = q[:, 0, r * hq:(r + 1) * hq]
    if q.device.type == "cuda":
        o = fused_decode_attention(q_loc, k_cache, v_cache, cache_index,
                                   k_scale=k_scale, v_scale=v_scale,
                                   window=window, block_table=block_table)
        S = k_cache.shape[1] if block_table is None \
            else block_table.shape[1] * k_cache.shape[1]
        keyed = (torch.clamp(_rows(cache_index, B, q.device), 0, S)
                 > 0).expand(B, hq)
        acc = o.float()
        m = torch.where(keyed, 0.0, NEG_INF)
        l = keyed.float()
    else:
        lanes = [t if t is None or block_table is None
                 else gather_paged_lanes(t, block_table)
                 for t in (k_cache, v_cache, k_scale, v_scale)]
        acc, m, l = decode_partials(q_loc, lanes[0], lanes[1], cache_index,
                                    k_scale=lanes[2], v_scale=lanes[3],
                                    window=window)
    acc_f = acc.new_zeros((B, Hq, D))
    m_f = torch.full((B, Hq), NEG_INF, dtype=torch.float32, device=q.device)
    l_f = torch.zeros((B, Hq), dtype=torch.float32, device=q.device)
    acc_f[:, r * hq:(r + 1) * hq] = acc
    m_f[:, r * hq:(r + 1) * hq] = m
    l_f[:, r * hq:(r + 1) * hq] = l
    m_star = mesh.all_reduce(m_f.clone(), op="max")
    scale = torch.exp(m_f - m_star)
    l_star = mesh.all_reduce(l_f * scale)
    o = mesh.all_reduce(acc_f * scale[..., None])
    o = o / torch.clamp(l_star, min=_EPS)[..., None]
    return o.reshape(B, 1, Hq, D).to(q.dtype)
