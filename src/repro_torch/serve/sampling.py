"""Next-token choice (``repro.serve.sampling``): greedy argmax and seeded
temperature / top-k sampling, token for token with the reference.

Greedy decoding stays the default: an all-greedy step calls only
:func:`greedy_tokens` and builds no sampling op. With ``temperature > 0``
the token is drawn from the temperature-scaled, optionally top-k-truncated
logits with a **per-(request, position) key**::

    key(seed)  --fold_in-->  position  --categorical-->  token

so a draw depends only on (request, absolute position, logits): not on the
slot, on what else is in flight, or on a preemption in between.

The draws reproduce jax 0.9's default PRNG bit for bit, written here from
its definitions (``jax/_src/prng.py``, ``jax/_src/random.py``):

* threefry2x32 (20 rounds, rotations 13 15 26 6 / 17 29 16 24, key
  schedule ``k1 ^ k2 ^ 0x1BD11BDA``), :func:`threefry2x32`;
* ``key(seed)`` of a 32-bit seed is the pair ``(0, seed)`` (the seed
  shifted right by 32, then its low word); ``fold_in(key, d)`` is
  ``threefry2x32(key, (0, d))``, whose two output words are the new key;
* 32-bit random bits in the **partitionable** layout (the default of jax
  0.9): element ``i`` of a ``(V,)`` draw hashes the 64-bit counter ``i``
  split into ``(hi, lo) = (0, i)`` and returns ``out1 ^ out2``;
* ``uniform`` keeps the top 23 bits as a mantissa, ``(bits >> 9) |
  0x3F800000`` viewed as float32, minus 1, scaled to ``[tiny, 1)`` and
  floored at ``tiny``; ``gumbel`` (the "low" mode) is ``-log(-log(u))``;
  ``categorical`` is ``argmax(logits + gumbel)``, the first index on ties.

torch has no usable uint32 arithmetic on the CPU or on CUDA, so every
32-bit word here lives in an **int64** tensor and each add and shift is
masked with ``& 0xFFFFFFFF``: no intermediate exceeds 2**62. Keys are
pairs ``(k1, k2)`` of such tensors with a batch shape. Everything runs on
the logits' device, with no host round trip.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["SamplingParams", "greedy_tokens", "sample_tokens",
           "sample_tokens_batch", "sample_or_greedy", "truncate_batch",
           "threefry2x32", "prng_key", "fold_in", "row_keys", "random_bits",
           "uniform", "gumbel", "categorical"]

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
# uniform's scale to [tiny, 1), computed in float32 as jax does (it is 1.0)
_SPAN = float(np.float32(1.0) - np.float32(_TINY))

Key = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request overrides of the engine-wide sampling defaults (``None``
    inherits): ``temperature`` 0 forces greedy, ``top_k`` 0 disables
    truncation, ``seed`` wins over ``Request.seed``."""

    temperature: Optional[float] = None
    top_k: Optional[int] = None
    seed: Optional[int] = None


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 argmax over the f32 logits (first index
    on ties, as ``jnp.argmax``). A row with a non-finite logit reports the
    ``-1`` sentinel, which the engine fails alone."""
    x = logits.float()
    nxt = torch.argmax(x, dim=-1).to(torch.int32)
    return _sentinel(x, nxt)


def _sentinel(x: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    bad = ~torch.isfinite(x).all(dim=-1)
    return torch.where(bad, torch.full_like(nxt, -1), nxt)


# -- threefry2x32 and the key operations --------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Key:
    """The threefry2x32 hash of counters ``(x1, x2)`` under key ``(k1,
    k2)``; int64 tensors holding uint32 words, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _word(a, device=None) -> torch.Tensor:
    """uint32 words as int64: a tensor (any int dtype, read as uint32) or
    anything ``np.asarray`` takes."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))
    return a.to(device=device, dtype=torch.int64) & _M32


def prng_key(seeds, device=None) -> Key:
    """``jax.random.key(seed)`` of 32-bit seeds: the pair ``(0, seed)``."""
    s = _word(seeds, device)
    return torch.zeros_like(s), s


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``: threefry2x32 of the counter pair
    ``(0, data)`` under ``key``."""
    d = _word(data, key[0].device)
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32, partitionable layout) as
    int64: shape ``key batch + (n,)``."""
    k1, k2 = key[0][..., None], key[1][..., None]
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: Key, n: int) -> torch.Tensor:
    """float32 uniforms in ``[tiny, 1)``, bit for bit with
    ``jax.random.uniform(key, (n,), minval=tiny, maxval=1)``."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * _SPAN + _TINY, _TINY)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in its default "low" mode."""
    return -torch.log(-torch.log(uniform(key, n)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (the Gumbel-max
    trick): (B, V) logits, one key per row -> (B,) int32."""
    g = gumbel(key, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


def row_keys(seeds, positions, device=None) -> Key:
    """One key per row: ``fold_in(key(seeds[b]), positions[b])``."""
    return fold_in(prng_key(seeds, device), _word(positions, device))


# -- samplers -----------------------------------------------------------


def sample_tokens(logits: torch.Tensor, seeds, positions,
                  temperature: float,
                  top_k: Optional[int] = None) -> torch.Tensor:
    """One draw per row at one engine-wide ``temperature`` (> 0) and
    ``top_k``; the cutoff is the k-th largest scaled logit, entries below
    it masked to ``NEG_INF``. Returns (B,) int32."""
    if temperature <= 0.0:
        raise ValueError("temperature must be > 0 for sampling; "
                         "the greedy path is plain argmax")
    x = logits.float() / temperature
    if top_k is not None and top_k < x.shape[-1]:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, NEG_INF, x)
    return categorical(row_keys(seeds, positions, x.device), x)


def truncate_batch(logits: torch.Tensor, temperatures,
                   top_ks) -> torch.Tensor:
    """The batch sampler's scores before the Gumbel draw: the f32 logits
    divided by each row's temperature (1 on greedy rows) and cut below the
    row's k-th largest value to ``NEG_INF`` (``top_ks <= 0``: no cut); the
    cutoff is the descending sort's ``k - 1``-th value, which is what
    ``top_k(x, k)[-1]`` in :func:`sample_tokens` gives."""
    x = logits.float()
    t = torch.as_tensor(temperatures, dtype=torch.float32, device=x.device)
    xs = x / torch.where(t > 0, t, torch.ones_like(t))[:, None]
    V = x.shape[-1]
    kk = torch.as_tensor(top_ks, device=x.device).to(torch.int64)
    k = torch.where(kk > 0, kk.clamp(1, V), torch.full_like(kk, V))
    srt = torch.sort(xs, dim=-1, descending=True).values
    kth = srt.gather(-1, (k - 1)[:, None])
    return torch.where(xs < kth, NEG_INF, xs)


def sample_tokens_batch(logits: torch.Tensor, seeds, positions,
                        temperatures, top_ks) -> torch.Tensor:
    """Per-row temperature and top-k in one pass, for mixed greedy and
    sampled batches: rows with ``temperatures == 0`` take the plain argmax
    of the f32 logits, the others draw from :func:`truncate_batch`'s
    scores with their own key, so a uniform batch draws
    :func:`sample_tokens`'s tokens. Non-finite rows are not flagged here
    (see :func:`sample_or_greedy`). Returns (B,) int32."""
    x = logits.float()
    greedy = torch.argmax(x, dim=-1).to(torch.int32)
    t = torch.as_tensor(temperatures, dtype=torch.float32, device=x.device)
    xs = truncate_batch(x, t, top_ks)
    sampled = categorical(row_keys(seeds, positions, x.device), xs)
    return torch.where(t > 0, sampled, greedy)


def sample_or_greedy(logits: torch.Tensor, sampling) -> torch.Tensor:
    """The engine's token choice for one step's (B, V) logits: the greedy
    lane alone when ``sampling`` is None (an all-greedy step), else
    :func:`sample_tokens_batch` with ``sampling = (seeds, positions,
    temperatures, top_ks)``. Either way a row with a non-finite logit
    reports ``-1``."""
    if sampling is None:
        return greedy_tokens(logits)
    return _sentinel(logits.float(), sample_tokens_batch(logits, *sampling))
