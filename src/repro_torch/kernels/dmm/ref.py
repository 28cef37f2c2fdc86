"""Plain PyTorch version of the DMM kernel (``repro.kernels.dmm.ref``):
``y = x @ LUT[codes]``.

``codes_packed`` holds two 4b codes per byte along K (row 2i in the high
nibble; odd K carries one zero-code pad row), the format the T-REX DMM
core streams. This is the wrapper's path on CPU tensors and the oracle the
CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

__all__ = ["unpack_nibbles", "dmm_reference"]


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(ceil(K/2), ...) uint8 -> (2 ceil(K/2), ...) uint8 codes in [0, 15]
    (row 2i from the high nibble)."""
    hi = packed >> 4
    lo = packed & 0xF
    return torch.stack([hi, lo], dim=1).reshape((-1,) + packed.shape[1:])


def dmm_reference(x: torch.Tensor, codes_packed: torch.Tensor,
                  lut: torch.Tensor) -> torch.Tensor:
    """x (M, K) float; codes_packed (ceil(K/2), N) uint8; lut (16,) f32 ->
    (M, N) f32: unpack, look up, crop the odd-K pad row, f32 product."""
    w = lut.float()[unpack_nibbles(codes_packed).long()][:x.shape[1]]  # (K, N)
    return x.float() @ w
