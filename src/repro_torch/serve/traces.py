"""Deterministic serving-traffic traces (the reference's
``benchmarks/traces.py``, numpy only).

A trace is a list of :class:`RequestSpec` on the engine's iteration axis
(the ``(tick, Request)`` contract of ``Engine.run``, ``Frontend.submit``
and ``Dispatcher.run``): each spec fixes a prompt length, an output budget
and whether the request carries its own sampling. Everything is drawn from
``np.random.default_rng(seed)`` in the reference's order, so a seed gives
the reference's specs and arrivals. :func:`poisson_trace` spaces arrivals
by geometric gaps (steady open-loop load); :func:`bursty_trace` sends
waves of near-simultaneous requests. Lengths are two-mode mixtures (short
and long prompts, chatty and terse outputs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request

__all__ = ["RequestSpec", "poisson_trace", "bursty_trace",
           "build_arrivals"]


@dataclass(frozen=True)
class RequestSpec:
    """One trace entry before materialization: lengths + sampling only,
    so a spec list can be replayed into fresh :class:`Request` objects
    for every engine under comparison."""
    tick: int
    prompt_len: int
    max_new_tokens: int
    sampled: bool = False  # per-request SamplingParams vs greedy default


def _lengths(rng: np.random.Generator, n: int,
             short: Tuple[int, int], long: Tuple[int, int],
             long_frac: float) -> np.ndarray:
    """Two-mode mixture: ``long_frac`` of entries from the long band."""
    is_long = rng.random(n) < long_frac
    lo = rng.integers(short[0], short[1] + 1, size=n)
    hi = rng.integers(long[0], long[1] + 1, size=n)
    return np.where(is_long, hi, lo)


def _specs(rng: np.random.Generator, ticks: np.ndarray,
           prompt_short: Tuple[int, int], prompt_long: Tuple[int, int],
           long_frac: float, out_short: Tuple[int, int],
           out_long: Tuple[int, int], sampled_frac: float
           ) -> List[RequestSpec]:
    n = len(ticks)
    plens = _lengths(rng, n, prompt_short, prompt_long, long_frac)
    olens = _lengths(rng, n, out_short, out_long, 0.3)
    samp = rng.random(n) < sampled_frac
    return [RequestSpec(tick=int(t), prompt_len=int(p),
                        max_new_tokens=int(o), sampled=bool(s))
            for t, p, o, s in zip(ticks, plens, olens, samp)]


def poisson_trace(n: int, seed: int, mean_gap: float = 2.0,
                  prompt_short: Tuple[int, int] = (4, 24),
                  prompt_long: Tuple[int, int] = (100, 300),
                  long_frac: float = 0.25,
                  out_short: Tuple[int, int] = (2, 6),
                  out_long: Tuple[int, int] = (8, 14),
                  sampled_frac: float = 0.5) -> List[RequestSpec]:
    """Open-loop steady load: geometric inter-arrival gaps with mean
    ``mean_gap`` ticks (discrete-time Poisson arrivals)."""
    rng = np.random.default_rng(seed)
    gaps = rng.geometric(p=min(1.0, 1.0 / max(mean_gap, 1e-9)), size=n)
    ticks = np.cumsum(gaps)
    return _specs(rng, ticks, prompt_short, prompt_long, long_frac,
                  out_short, out_long, sampled_frac)


def bursty_trace(n_bursts: int, burst_size: int, seed: int,
                 gap_ticks: int = 12,
                 prompt_short: Tuple[int, int] = (4, 24),
                 prompt_long: Tuple[int, int] = (100, 300),
                 long_frac: float = 0.4,
                 out_short: Tuple[int, int] = (2, 6),
                 out_long: Tuple[int, int] = (8, 14),
                 sampled_frac: float = 0.5) -> List[RequestSpec]:
    """Wave arrivals: ``n_bursts`` clusters of ``burst_size`` requests
    landing within 2 ticks of the wave front, waves ``gap_ticks``
    apart — later waves arrive mid-decode of earlier ones."""
    rng = np.random.default_rng(seed)
    ticks = np.concatenate([
        1 + b * gap_ticks + rng.integers(0, 3, size=burst_size)
        for b in range(n_bursts)])
    return _specs(rng, np.sort(ticks), prompt_short, prompt_long,
                  long_frac, out_short, out_long, sampled_frac)


def build_arrivals(specs: List[RequestSpec], vocab_size: int, seed: int,
                   rid0: int = 0, base_sampling_seed: int = 1000
                   ) -> List[Tuple[int, Request]]:
    """Materialize a spec list into fresh ``(tick, Request)`` arrivals.

    Prompt tokens and per-request :class:`SamplingParams` derive only
    from ``seed`` and the spec order, so calling this twice yields
    request streams that decode byte-identically — hand one copy to each
    engine under comparison (requests are stateful; never share them)."""
    rng = np.random.default_rng(seed)
    out: List[Tuple[int, Request]] = []
    for i, sp in enumerate(specs):
        prompt = rng.integers(1, vocab_size,
                              size=sp.prompt_len).astype(np.int32)
        sampling: Optional[SamplingParams] = None
        if sp.sampled:
            sampling = SamplingParams(temperature=0.7, top_k=8,
                                      seed=base_sampling_seed + i)
        out.append((sp.tick, Request(rid=rid0 + i, prompt=prompt,
                                     max_new_tokens=sp.max_new_tokens,
                                     sampling=sampling)))
    return out
