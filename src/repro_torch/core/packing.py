"""Dynamic batching (paper Fig. 23.1.4) as sequence packing
(``repro.core.packing``).

T-REX lets an input of at most max_len/2 (max_len/4) share the datapath
with 1 (3) other short inputs, so one load of the parameters serves 2 (4)
inputs. The serving analogue packs several requests into one
``(row, max_len)`` prefill row with segment ids; attention is masked
block-diagonally. Host logic is numpy; :func:`segment_mask` builds the
mask as a torch tensor.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PackingPolicy", "PackedBatch", "pack_requests", "chunk_prompt",
           "segment_mask", "packing_utilization"]


@dataclasses.dataclass(frozen=True)
class PackingPolicy:
    """Lengths in (max/2, max] ride alone; (max/4, max/2] pair up; <= max/4
    go four to a row. ``max_per_row`` caps how deep the packing goes."""

    max_len: int = 128
    max_per_row: int = 4

    def bucket(self, length: int) -> int:
        """Number of inputs of this length that share one row."""
        if length <= 0 or length > self.max_len:
            raise ValueError(f"length {length} out of (0, {self.max_len}]")
        share = 1
        while (share < self.max_per_row
               and length <= self.max_len // (share * 2)):
            share *= 2
        return share


@dataclasses.dataclass
class PackedBatch:
    """Fixed-shape packed batch. ``segment_ids`` is 0 for padding, 1.. for
    requests; ``request_slots[i] = (row, start, length)`` recovers outputs."""

    tokens: np.ndarray       # (rows, max_len) int32
    segment_ids: np.ndarray  # (rows, max_len) int32
    positions: np.ndarray    # (rows, max_len) int32, within-request
    request_slots: List[Tuple[int, int, int]]

    @property
    def rows(self) -> int:
        return self.tokens.shape[0]


def pack_requests(requests: Sequence[np.ndarray],
                  policy: PackingPolicy) -> PackedBatch:
    """First-fit-decreasing packing of requests into rows of ``max_len``
    tokens, at most ``policy.max_per_row`` requests a row. Requests longer
    than ``max_len`` must be chunked by the caller."""
    order = sorted(range(len(requests)), key=lambda i: -len(requests[i]))
    row_used: List[int] = []
    row_count: List[int] = []
    assignment = {}
    for i in order:
        n = len(requests[i])
        placed = False
        if policy.bucket(n) > 1:
            for rix in range(len(row_used)):
                if (row_count[rix] < policy.max_per_row
                        and row_used[rix] + n <= policy.max_len):
                    assignment[i] = (rix, row_used[rix])
                    row_used[rix] += n
                    row_count[rix] += 1
                    placed = True
                    break
        if not placed:
            assignment[i] = (len(row_used), 0)
            row_used.append(n)
            row_count.append(1)

    n_rows = len(row_used)
    tokens = np.zeros((n_rows, policy.max_len), np.int32)
    seg = np.zeros((n_rows, policy.max_len), np.int32)
    pos = np.zeros((n_rows, policy.max_len), np.int32)
    slots: List[Tuple[int, int, int]] = []
    for i, req in enumerate(requests):
        rix, start = assignment[i]
        n = len(req)
        tokens[rix, start:start + n] = np.asarray(req, np.int32)
        seg[rix, start:start + n] = i + 1
        pos[rix, start:start + n] = np.arange(n)
        slots.append((rix, start, n))
    return PackedBatch(tokens=tokens, segment_ids=seg, positions=pos,
                       request_slots=slots)


def chunk_prompt(prompt: np.ndarray, max_len: int) -> List[np.ndarray]:
    """Split a prompt into consecutive chunks of at most ``max_len``
    tokens; concatenating them reproduces ``prompt``."""
    if max_len <= 0:
        raise ValueError(f"max_len must be positive, got {max_len}")
    prompt = np.asarray(prompt)
    if prompt.ndim != 1 or len(prompt) == 0:
        raise ValueError("prompt must be a non-empty 1-D token array")
    return [prompt[i:i + max_len] for i in range(0, len(prompt), max_len)]


def segment_mask(seg_q: torch.Tensor, seg_kv: torch.Tensor,
                 causal: bool = True) -> torch.Tensor:
    """(B, Sq, Skv) bool: same nonzero segment (and causal within it, with
    the queries aligned at the end of the kv axis)."""
    same = (seg_q[:, :, None] == seg_kv[:, None, :]) & (seg_q[:, :, None] > 0)
    if causal:
        sq, skv = seg_q.shape[1], seg_kv.shape[1]
        tri = torch.ones((sq, skv), dtype=torch.bool,
                         device=seg_q.device).tril(skv - sq)
        same = same & tri[None]
    return same


def packing_utilization(batch: PackedBatch) -> float:
    """Fraction of the (rows x max_len) token slots doing useful work."""
    return float((batch.segment_ids > 0).mean())
