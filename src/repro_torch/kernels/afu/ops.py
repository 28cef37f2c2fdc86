"""Public AFU ops (``repro.kernels.afu.ops``): any leading shape, flattened
to rows of the last axis, f32 out."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.afu.afu import layernorm_residual, softmax_lut
from repro_torch.kernels.afu.ref import exp_lut_table, softmax_lut_reference

__all__ = ["fused_softmax", "fused_layernorm_residual"]


@functools.lru_cache(maxsize=None)
def _table(device: torch.device) -> torch.Tensor:
    """The LUT, made once per device (a constant of the AFU)."""
    return exp_lut_table(device)


def fused_softmax(x: torch.Tensor, *, use_kernel: bool = True
                  ) -> torch.Tensor:
    """LUT-exp softmax over the last axis of an (..., C) tensor, f32 out.
    ``use_kernel=False`` runs the plain version; the kernel wrapper runs it
    too on CPU tensors."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if not use_kernel:
        return softmax_lut_reference(x2).reshape(shape)
    return softmax_lut(x2.contiguous(), _table(x.device)).reshape(shape)


def fused_layernorm_residual(x: torch.Tensor, res: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor
                             ) -> torch.Tensor:
    """Fused ``(x + res)`` -> LayerNorm (eps 1e-6) over the last axis of
    (..., C) tensors; scale and bias (C,). f32 out."""
    shape = x.shape
    out = layernorm_residual(
        x.reshape(-1, shape[-1]).contiguous(),
        res.reshape(-1, shape[-1]).contiguous(),
        scale.float().contiguous(), bias.float().contiguous())
    return out.reshape(shape)
