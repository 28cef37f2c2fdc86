"""Linear layers: the dense branch of ``repro.core.factorized``.

The port serves dense weights only. :class:`FactorizationConfig` comes
along (disabled by default) so configs keep the reference's fields; a
config that enables it is refused by ``Model`` — the factorized and
compressed weight streams (and their ``dmm``/``smm`` kernels) come with a
later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

__all__ = ["FactorizationConfig", "apply_linear"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class FactorizationConfig:
    """Same fields and defaults as the reference's switch for the T-REX
    shared-dictionary factorization."""

    enabled: bool = False
    rank_ratio: float = 0.625
    rank: Optional[int] = None
    nnz_ratio: float = 0.125
    nnz: Optional[int] = None
    min_dim: int = 256
    reg_coeff: float = 1e-4
    ste_in_forward: bool = True

    def rank_for(self, d_in: int, d_out: Optional[int] = None) -> int:
        if self.rank is not None:
            return self.rank
        base = d_in if d_out is None else min(d_in, d_out)
        return max(128, _round_up(int(self.rank_ratio * base), 128))

    def nnz_for(self, r: int) -> int:
        if self.nnz is not None:
            return min(self.nnz, r)
        return max(1, int(self.nnz_ratio * r))

    def applies_to(self, d_in: int, d_out: int) -> bool:
        return self.enabled and min(d_in, d_out) >= self.min_dim


def apply_linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``y = x @ w (+ b)`` with ``w`` laid out ``(d_in, d_out)``.

    ``w`` and ``b`` are used in ``x``'s (the compute) dtype.
    ``Model.prepare`` makes that copy once at load time, so on the serving
    path the ``.to`` below is a no-op. At float32 this is the reference's
    arithmetic exactly. At bf16 compute over f32 params the reference's
    dense branch promotes to an f32 product instead (bf16 ``x`` times f32
    ``w``); the port multiplies in bf16, as the reference's compressed-weight
    branch does (``apply_compressed_linear``)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y
