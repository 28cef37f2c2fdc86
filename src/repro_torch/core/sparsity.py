"""Fixed-NZ-per-column sparsity for W_D (``repro.core.sparsity``, the
projection used at serving time). The training-side pieces (the
straight-through estimator and the out-of-support regularizer) are not
ported: the port does not train."""
from __future__ import annotations

import torch

__all__ = ["topk_column_mask", "project_topk_columns"]


def topk_column_mask(wd: torch.Tensor, nnz: int) -> torch.Tensor:
    """Boolean mask keeping the ``nnz`` largest-|.| entries of each column
    of ``wd`` (r, d_out): ``torch.topk`` over the rows of each column."""
    nnz = min(nnz, wd.shape[0])
    idx = torch.topk(wd.abs(), nnz, dim=0).indices  # (nnz, d_out)
    mask = torch.zeros(wd.shape, dtype=torch.bool, device=wd.device)
    return mask.scatter_(0, idx, True)


def project_topk_columns(wd: torch.Tensor, nnz: int) -> torch.Tensor:
    return torch.where(topk_column_mask(wd, nnz), wd, 0.0)
