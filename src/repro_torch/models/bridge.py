"""Parameter bridge: a reference ``Model.init`` tree, converted to nested
dicts of numpy arrays by the caller, becomes the port's parameters.

The port never sees JAX: a caller holding reference parameters converts
them first, e.g. ``jax.tree.map(np.asarray, params)``, and hands the
numpy tree here. The layout is kept as it is (uniform stacks carry the
leading L axis on ``params["layers"]``)."""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

__all__ = ["params_from_numpy"]


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def params_from_numpy(tree: Any,
                      device: Optional[Union[str, torch.device]] = None):
    """Nested dicts (and lists/tuples) of numpy arrays -> the same
    structure of tensors on ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _to_tensor(x, dev)

    return conv(tree)
