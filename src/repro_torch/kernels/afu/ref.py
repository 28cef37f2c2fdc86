"""Plain PyTorch version of the AFU (``repro.kernels.afu.ref``): softmax
with the chip's LUT exponential, residual + LayerNorm, tanh GELU.

The T-REX AFU evaluates exp() through a lookup table. It is modelled as a
64-entry piecewise-linear exp on ``[-LUT_RANGE, 0]``; inputs are
max-subtracted so they land there. Below ``-LUT_RANGE`` the input clamps,
so ``lut_exp`` returns ``table[0] = exp(-16)``, about 1.1e-7, never 0:
masked attention keys reach 0 only through the mask applied after the
exp. These are the wrappers' path on CPU tensors and the oracle the CUDA
kernels are held against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["LUT_SIZE", "LUT_RANGE", "exp_lut_table", "lut_exp",
           "softmax_lut_reference", "layernorm_residual_reference",
           "gelu_reference"]

LUT_SIZE = 64
LUT_RANGE = 16.0  # exp(-16) ~ 1e-7: below the 6b/8b activation resolution


def exp_lut_table(device=None) -> torch.Tensor:
    """(LUT_SIZE,) f32: exp at ``LUT_SIZE`` evenly spaced points of
    ``[-LUT_RANGE, 0]`` (on ``device``, the CPU by default)."""
    # linspace as the reference computes it in f32 (t = i times the f32
    # reciprocal of LUT_SIZE - 1, then start * (1 - t) + stop * t), so
    # that both tables sample exp at the same points
    t = torch.arange(LUT_SIZE - 1, dtype=torch.float32, device=device) \
        * torch.tensor(1.0 / (LUT_SIZE - 1), dtype=torch.float32)
    start, stop = -LUT_RANGE, 0.0
    xs = torch.cat([start * (1 - t) + stop * t,
                    torch.full((1,), stop, device=device)])
    return torch.exp(xs)


def lut_exp(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear exp for x <= 0; x below -LUT_RANGE clamps to
    ``table[0]``."""
    xc = torch.clamp(x, -LUT_RANGE, 0.0)
    f = (xc + LUT_RANGE) / LUT_RANGE * (LUT_SIZE - 1)
    i0 = torch.clamp(torch.floor(f).to(torch.int32), 0, LUT_SIZE - 2)
    frac = f - i0
    lo = table[i0.long()]
    hi = table[i0.long() + 1]
    return lo + (hi - lo) * frac


def softmax_lut_reference(x: torch.Tensor,
                          table: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Row softmax over the last axis with the LUT exp, in f32 (``table``
    defaults to :func:`exp_lut_table` on x's device)."""
    if table is None:
        table = exp_lut_table(x.device)
    x = x.float()
    m = x.max(-1, keepdim=True).values
    e = lut_exp(x - m, table)
    return e / e.sum(-1, keepdim=True)


def layernorm_residual_reference(x: torch.Tensor, res: torch.Tensor,
                                 scale: torch.Tensor, bias: torch.Tensor,
                                 eps: float = 1e-6) -> torch.Tensor:
    """The AFU's fused pass: ``h = x + res`` in f32, then LayerNorm (mean,
    then the variance of ``h - mean``) times ``scale`` plus ``bias``."""
    h = x.float() + res.float()
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) / torch.sqrt(var + eps) * scale + bias


def gelu_reference(x: torch.Tensor) -> torch.Tensor:
    """tanh-approx GELU (what a LUT+ALU datapath implements)."""
    xf = x.float()
    return 0.5 * xf * (1.0 + torch.tanh(0.7978845608
                                        * (xf + 0.044715 * xf ** 3)))
