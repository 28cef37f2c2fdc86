"""Host -> device batch loading (``repro.data.loader``): each numpy batch
becomes tensors on the model's device. On CUDA the arrays are staged in
pinned host memory and copied with ``non_blocking=True``, so the copy
overlaps the host's work on the step before it."""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

__all__ = ["device_batches", "to_device"]


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """One numpy batch as tensors on ``device`` (pinned, non-blocking
    copies on CUDA)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def device_batches(host_iter: Iterator[Dict[str, np.ndarray]],
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    dev = resolve_device(device)
    for batch in host_iter:
        yield to_device(batch, dev)
