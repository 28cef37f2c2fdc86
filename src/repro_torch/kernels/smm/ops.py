"""Public SMM op (``repro.kernels.smm.ops``): the compressed-W_D matmul,
the second product of the paper's sequential pair."""
from __future__ import annotations

import torch

from repro_torch.kernels.smm.ref import VALUE_BITS, smm_reference
from repro_torch.kernels.smm.smm import smm_matmul

__all__ = ["compressed_matmul"]


def _scalar(v, dtype, device) -> torch.Tensor:
    """A 0-d tensor on ``device`` (no copy when ``v`` already is one)."""
    return torch.as_tensor(v, dtype=dtype, device=device).reshape(())


def compressed_matmul(y: torch.Tensor, first: torch.Tensor,
                      deltas: torch.Tensor, vq: torch.Tensor, scale, offset,
                      *, value_bits=VALUE_BITS,
                      use_kernel: bool = True) -> torch.Tensor:
    """z = y @ densify(first, deltas, vq, scale, offset). ``scale``,
    ``offset`` and ``value_bits`` are numbers or scalar tensors (a layer's
    slice of the streamed ``(L,)`` leaves). ``use_kernel=False`` runs the
    plain version; the kernel wrapper runs it too on CPU tensors."""
    dev = y.device
    scale = _scalar(scale, torch.float32, dev)
    offset = _scalar(offset, torch.float32, dev)
    bits = _scalar(value_bits, torch.int32, dev)
    if not use_kernel:
        return smm_reference(y, first, deltas, vq, scale, offset, bits)
    return smm_matmul(y.float().contiguous(),
                      first.to(torch.int32).contiguous(), deltas.contiguous(),
                      vq.contiguous(), scale, offset, bits)
