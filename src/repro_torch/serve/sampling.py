"""Next-token choice (``repro.serve.sampling``): the greedy lane.

:class:`SamplingParams` keeps the reference's per-request overrides so a
request carries the same fields; the engine refuses any that ask for
sampling (temperature > 0 or top-k) — seeded sampling needs the
reference's threefry draws bit for bit and comes with a later slice
(ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SamplingParams", "greedy_tokens"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    seed: Optional[int] = None


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 argmax over the f32 logits (first index
    on ties, as ``jnp.argmax``). A row with a non-finite logit reports the
    ``-1`` sentinel, which the engine fails alone."""
    x = logits.float()
    nxt = torch.argmax(x, dim=-1).to(torch.int32)
    bad = ~torch.isfinite(x).all(dim=-1)
    return torch.where(bad, torch.full_like(nxt, -1), nxt)
