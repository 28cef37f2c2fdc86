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
same formula, in split order. Written with torch ops; the tensor-parallel
mesh path of the reference is not ported.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.tda.ref import NEG_INF, _dequant, _rows

__all__ = ["decode_partials", "merge_partials"]

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
