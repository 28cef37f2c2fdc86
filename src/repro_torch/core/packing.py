"""Prompt chunking (``repro.core.packing.chunk_prompt``). Packed prefill
rows (``pack_requests``) belong to the serialized-prefill path, which
comes with a later slice."""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["chunk_prompt"]


def chunk_prompt(prompt: np.ndarray, max_len: int) -> List[np.ndarray]:
    """Split a prompt into consecutive chunks of at most ``max_len``
    tokens; concatenating them reproduces ``prompt``."""
    if max_len <= 0:
        raise ValueError(f"max_len must be positive, got {max_len}")
    prompt = np.asarray(prompt)
    if prompt.ndim != 1 or len(prompt) == 0:
        raise ValueError("prompt must be a non-empty 1-D token array")
    return [prompt[i:i + max_len] for i in range(0, len(prompt), max_len)]
