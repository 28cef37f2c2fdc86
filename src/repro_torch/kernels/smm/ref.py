"""Plain PyTorch version of the SMM kernel (``repro.kernels.smm.ref``):
``z = y @ densify(W_D streams)``.

W_D arrives in the T-REX streaming format:
  first   (N,)       int32        absolute first row index per column
  deltas  (nnz-1, N) uint8/int16  delta-encoded remaining row indices
  vq      (nnz, N)   uint8        uniform value codes
  scale, offset      f32          per-layer dequant constants
  value_bits         int          value quantizer width

This is the wrapper's path on CPU tensors and the oracle the CUDA kernel
is held against on the card.
"""
from __future__ import annotations

import torch

__all__ = ["VALUE_BITS", "decode_indices", "dequant_values", "densify",
           "smm_reference"]

VALUE_BITS = 6


def decode_indices(first: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """-> (nnz, N) int64 absolute row indices (ascending per column)."""
    f = first[None].to(torch.int64)
    return torch.cat([f, f + torch.cumsum(deltas.to(torch.int64), dim=0)])


def dequant_values(vq: torch.Tensor, scale, offset,
                   value_bits=VALUE_BITS) -> torch.Tensor:
    """``vq / (2^bits - 1) * scale + offset`` in f32; ``value_bits`` may be
    a tensor (the serving path streams it per layer)."""
    levels = torch.exp2(torch.as_tensor(value_bits, dtype=torch.float32,
                                        device=vq.device)) - 1.0
    return vq.float() / levels * scale + offset


def densify(first, deltas, vq, scale, offset, r: int,
            value_bits=VALUE_BITS) -> torch.Tensor:
    """Dense (r, N) f32 W_D: indices outside ``[0, r)`` are dropped and
    duplicates add, as the reference's scatter does."""
    idx = decode_indices(first, deltas)
    vals = dequant_values(vq, scale, offset, value_bits)
    cols = torch.arange(idx.shape[1], device=idx.device).expand_as(idx)
    keep = (idx >= 0) & (idx < r)
    dense = torch.zeros((r, idx.shape[1]), dtype=torch.float32,
                        device=idx.device)
    return dense.index_put_((idx[keep], cols[keep]), vals[keep],
                            accumulate=True)


def smm_reference(y: torch.Tensor, first, deltas, vq, scale, offset,
                  value_bits=VALUE_BITS) -> torch.Tensor:
    """y (M, r) x compressed W_D (r, N) -> (M, N) f32."""
    dense = densify(first, deltas, vq, scale, offset, y.shape[1], value_bits)
    return y.float() @ dense
