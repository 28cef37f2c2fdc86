"""The one general generator of the benchmark's traffic: a mix is a JSON
file of ``bench/traffic/`` that fixes lengths, arrivals and the engine
settings a deployment would serve them with.

Every seed replays one trace: the sizes and gaps are drawn once from the
mix's own ``size_seed`` (log-uniform lengths, exponential gaps at the
mix's rate) and come in the same order for every seed; ``--seed`` draws
the token ids. Letting the seed order the sizes changed the work: which
long prompts met in a burst and which lists ran side by side moved the
p95 of time to first token by 20 % and the window's tokens by 5 % from
seed to seed, where two runs of one seed agreed within 2 %. (The
program's ``serve/traces.py`` draws lengths and geometric gaps the same
way on its iteration clock; this copy works in seconds.)

* ``"loop": "closed"``: ``clients`` callers, each sending its next request
  as soon as its last one finishes (no think time), each from a fixed
  list of ``per_client`` requests.
* ``"loop": "open"``: ``round(rate x seconds)`` requests due at fixed
  times within the window, whatever the engine has done by then: their
  gaps are exponential, scaled so that the window holds them all.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

__all__ = ["Mix", "Item", "load_mix", "mix_from_dict", "draw_sizes",
           "draw_items"]


@dataclasses.dataclass(frozen=True)
class Item:
    """One request before it is materialized: its prompt tokens, output
    budget, (open loop) the second at which it is due, and (closed loop)
    its caller."""
    idx: int
    prompt: np.ndarray
    max_new: int
    due_s: float
    client: int = -1


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    loop: str
    clients: int
    rate_per_s: float
    prompt: Dict
    output: Dict
    per_client: int
    size_seed: int
    engine: Dict


def mix_from_dict(d: Dict) -> Mix:
    if d["loop"] not in ("open", "closed"):
        raise ValueError(f"loop must be open or closed, got {d['loop']!r}")
    return Mix(name=d["name"], loop=d["loop"], clients=int(d.get("clients", 0)),
               rate_per_s=float(d.get("rate_per_s", 0.0)), prompt=d["prompt"],
               output=d["output"], per_client=int(d.get("per_client", 0)),
               size_seed=int(d["size_seed"]), engine=dict(d["engine"]))


def load_mix(path) -> Mix:
    return mix_from_dict(json.loads(Path(path).read_text()))


def _lengths(rng: np.random.Generator, band: Dict, n) -> np.ndarray:
    lo, hi = float(band["min"]), float(band["max"])
    if band.get("dist", "log_uniform") != "log_uniform":
        raise ValueError(f"unknown length distribution {band['dist']!r}")
    x = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=n))
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def draw_sizes(mix: Mix, seconds: float):
    """``(prompt_lengths, output_budgets, gaps_s)``, the same for every run
    seed: a closed loop's ``(clients, per_client)`` lists (no gaps), or an
    open loop's ``round(rate x seconds)`` requests and one gap more than
    them, the gaps summing to ``seconds`` (the last one, after the last
    arrival, is never moved)."""
    rng = np.random.default_rng(mix.size_seed)
    if mix.loop == "closed":
        shape = (mix.clients, mix.per_client)
        return (_lengths(rng, mix.prompt, shape),
                _lengths(rng, mix.output, shape), np.zeros(0))
    n = max(1, int(round(mix.rate_per_s * seconds)))
    plen, olen = _lengths(rng, mix.prompt, n), _lengths(rng, mix.output, n)
    gaps = rng.exponential(1.0, size=n + 1)
    return plen, olen, gaps * (seconds / gaps.sum())


def draw_items(mix: Mix, seed: int, vocab: int,
               seconds: float) -> List[Item]:
    """This seed's requests: a closed loop's lists, caller ``c`` sending
    row ``c`` (caller-major within each round), or an open loop's sizes due
    at the running sum of the gaps; token ids drawn from the seed."""
    plen, olen, gaps = draw_sizes(mix, seconds)
    seed = int(seed) % 2**64
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x7EC])
    if mix.loop == "closed":
        rows = [(c, k, int(plen[c, k]), int(olen[c, k]))
                for k in range(mix.per_client) for c in range(mix.clients)]
        due = [0.0] * len(rows)
    else:
        rows = [(-1, 0, int(p), int(o)) for p, o in zip(plen, olen)]
        due = np.cumsum(gaps[:-1]).tolist()
    return [Item(idx=i, prompt=rng.integers(0, vocab, size=p)
                 .astype(np.int32), max_new=o, due_s=float(t), client=c)
            for i, ((c, _k, p, o), t) in enumerate(zip(rows, due))]
