"""Parameter bridge: a reference ``Model.init`` tree (or a whole train
state), converted to nested dicts of numpy arrays by the caller, becomes
the port's tensors.

The port never sees JAX: a caller holding reference parameters converts
them first, e.g. ``jax.tree.map(np.asarray, params)``, and hands the
numpy tree here. The layout is kept as it is (uniform stacks carry the
leading L axis on ``params["layers"]``; MoE experts ``(L, E, ...)``, and
their compressed streams the same leading dims; an ``EncDecModel`` tree
its ``encoder`` / ``decoder`` ``layer_XX`` dicts)."""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

__all__ = ["params_from_numpy", "state_from_numpy"]


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.require(np.asarray(a), requirements="C")  # 0-d stays 0-d
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


def state_from_numpy(tree: Any,
                     device: Optional[Union[str, torch.device]] = None):
    """A reference train state ``{"params", "opt", "step"}`` as numpy (the
    optimizer's trees as ``init_opt_state`` lays them out: AdamW ``{"m",
    "v"}``, Adafactor ``{"v"}`` with ``{"v"}`` or ``{"vr", "vc"}`` per
    leaf) -> the port's state on ``device``, ``step`` an int32 0-d
    tensor, so both packages can go on from one state."""
    missing = {"params", "opt", "step"} - set(tree)
    if missing:
        raise KeyError(f"train state lacks {sorted(missing)}")
    out = params_from_numpy({k: tree[k] for k in ("params", "opt")}, device)
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32,
                               device=resolve_device(device))
    return out
