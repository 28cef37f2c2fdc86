"""Public DMM op (``repro.kernels.dmm.ops``): the LUT-dequant matmul."""
from __future__ import annotations

import torch

from repro_torch.kernels.dmm.dmm import dmm_matmul
from repro_torch.kernels.dmm.ref import dmm_reference

__all__ = ["lut_matmul"]


def lut_matmul(x: torch.Tensor, codes_packed: torch.Tensor,
               lut: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """y (M, N) f32 = x (M, K) @ LUT[codes]. An odd K's codes carry one
    zero-code pad row (``pack_nibbles``); the reference pads ``x`` with a
    zero column to match, the kernel reads ``x`` only for ``k < K`` — the
    same product, without the copy. ``use_kernel=False`` runs the plain
    version; the kernel wrapper runs it too on CPU tensors."""
    if codes_packed.shape[0] != (x.shape[1] + 1) // 2:
        raise ValueError(f"lut_matmul: codes_packed "
                         f"{tuple(codes_packed.shape)} does not pack "
                         f"K={x.shape[1]}")
    if not use_kernel:
        return dmm_reference(x, codes_packed, lut)
    return dmm_matmul(x.contiguous(), codes_packed.contiguous(),
                      lut.contiguous())
