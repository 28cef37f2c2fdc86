"""Deterministic synthetic data (``repro.data.synthetic``, in numpy): token
streams with learnable structure for the trainer, and request-length
distributions for the serving launchers.

The LM stream is a tiny order-2 Markov chain over the vocab: random enough
to be non-trivial, structured enough that a model's loss drops below the
uniform baseline within a few hundred steps. For every ``seed`` and
``n_codebooks`` the batches are the reference's, bit for bit (the same
``np.random.default_rng`` draws in the same order).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np

__all__ = ["MarkovLM", "lm_batches", "request_lengths"]


@dataclasses.dataclass
class MarkovLM:
    vocab_size: int
    branch: int = 8  # successors per (prev, cur) state
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # successor table (2, V, branch): the next token depends on the
        # current one and a parity bit of the previous one.
        self.table = rng.integers(0, self.vocab_size,
                                  size=(2, self.vocab_size, self.branch))

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length + 1, np.int64)
        out[0] = rng.integers(self.vocab_size)
        out[1] = rng.integers(self.vocab_size)
        for t in range(2, length + 1):
            parity = out[t - 2] & 1
            out[t] = self.table[parity, out[t - 1],
                                rng.integers(self.branch)]
        return out


def lm_batches(vocab_size: int, batch: int, seq: int, *, seed: int = 0,
               n_codebooks: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of ``{"inputs" (B, S), "labels"}`` int32 next-token
    batches; ``labels`` is ``(B, S, n_codebooks)`` for a multi-codebook
    head (the same labels on every codebook)."""
    lm = MarkovLM(vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        rows = np.stack([lm.sample(rng, seq) for _ in range(batch)])
        inputs = rows[:, :-1].astype(np.int32)
        labels = rows[:, 1:].astype(np.int32)
        if n_codebooks > 1:
            labels = np.stack([labels] * n_codebooks, axis=-1) % vocab_size
        yield {"inputs": inputs, "labels": labels}


def request_lengths(n: int, max_len: int = 128, dist: str = "bert",
                    seed: int = 0) -> List[int]:
    """Request-length samples of the paper's workload profiles:
    ``"uniform"`` in ``[1, max_len]``, ``"vit"`` fixed grids of
    ``max_len``, ``"bert"`` many short inputs (buckets at max_len/8, /4,
    /2 and max_len, jittered down)."""
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        return list(rng.integers(1, max_len + 1, size=n))
    if dist == "vit":
        return [max_len] * n
    buckets = [max_len // 8, max_len // 4, max_len // 2, max_len]
    idx = rng.choice(len(buckets), size=n, p=[0.25, 0.4, 0.25, 0.1])
    jitter = rng.integers(-max_len // 16, 1, size=n)
    return [int(np.clip(buckets[i] + j, 1, max_len))
            for i, j in zip(idx, jitter)]
