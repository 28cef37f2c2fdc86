"""Fixed-NZ-per-column sparsity for W_D (``repro.core.sparsity``, paper
Fig. 23.1.3): each column of W_D keeps a fixed number of non-zeros.

Training reaches it with

- a **magnitude top-k projection per column** in the forward pass with a
  straight-through gradient (:func:`ste_sparse`: dense gradients keep
  flowing into pruned slots, so the support can migrate), and
- an **L1 penalty on the out-of-support mass**
  (:func:`out_of_support_l1`), which drives the entries outside the
  top-k toward exact zero so the projection is lossless at compression.

Serving uses the projection alone (:func:`project_topk_columns`). The
mask takes ``torch.topk`` over the rows of each column; ``lax.top_k``
may order equal magnitudes otherwise, which seeded float weights do not
produce.
"""
from __future__ import annotations

import torch

__all__ = ["topk_column_mask", "project_topk_columns", "ste_sparse",
           "out_of_support_l1", "column_sparsity"]


def topk_column_mask(wd: torch.Tensor, nnz: int) -> torch.Tensor:
    """Boolean mask keeping the ``nnz`` largest-|.| entries of each column
    of ``wd`` (r, d_out): ``torch.topk`` over the rows of each column."""
    nnz = min(nnz, wd.shape[0])
    idx = torch.topk(wd.detach().abs(), nnz, dim=0).indices  # (nnz, d_out)
    mask = torch.zeros(wd.shape, dtype=torch.bool, device=wd.device)
    return mask.scatter_(0, idx, True)


def project_topk_columns(wd: torch.Tensor, nnz: int) -> torch.Tensor:
    return torch.where(topk_column_mask(wd, nnz), wd, 0.0)


def ste_sparse(wd: torch.Tensor, nnz: int) -> torch.Tensor:
    """Forward: the projected sparse W_D. Backward: the identity
    (straight-through)."""
    return wd + (project_topk_columns(wd, nnz) - wd).detach()


def out_of_support_l1(wd: torch.Tensor, nnz: int) -> torch.Tensor:
    """L1 mass outside the per-column top-k support, over the entry count
    (so the coefficient carries across layer sizes)."""
    off = torch.where(topk_column_mask(wd, nnz), 0.0, wd)
    return off.abs().sum() / max(off.numel(), 1)


def column_sparsity(wd: torch.Tensor, tol: float = 0.0) -> torch.Tensor:
    """Fraction of exactly- (or ``tol``-) zero entries of one matrix."""
    return (wd.abs() <= tol).float().mean()
