"""Device resolution shared by every entry point and kernel dispatch.

``resolve_device(None)`` is the CUDA device; a missing CUDA device raises
instead of falling back to the CPU, which only an explicit
``device="cpu"`` selects (the tests do). ``resolve_decode_attn("auto")``
picks the hand-written TDA kernels on a CUDA device and the plain dense
path on the CPU, as the reference picks its Pallas kernels on a TPU.
``merge_counters`` holds the int32 counters with which the kernels that
merge their splits in the launch elect the last block.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "resolve_decode_attn", "merge_counters"]

_COUNTERS: dict = {}  # device -> int32 counters, 0 between launches


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for (explicitly or
    by default) and no CUDA device exists. Never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on an NVIDIA GPU "
            "by default; pass device='cpu' explicitly to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_decode_attn(mode: str, device: torch.device) -> str:
    """``auto`` -> ``tda`` on a CUDA device, ``dense`` on the CPU (there
    the TDA wrappers would run their plain versions anyway)."""
    if mode == "auto":
        return "tda" if torch.device(device).type == "cuda" else "dense"
    if mode not in ("dense", "tda"):
        raise ValueError(f"unknown decode_attn mode {mode!r}")
    return mode


def merge_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters on ``device``, zeroed once and shared
    by every launch there: the kernels run on one stream, in order, and
    each block that merges resets its counter to 0."""
    cnt = _COUNTERS.get(device)
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = cnt
    return cnt
