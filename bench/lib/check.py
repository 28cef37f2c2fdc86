"""What decides ``correct``: the served tokens of the window, held against
the plain reference.

Once the window has closed (and the program's state is freed), a sample
drawn from the seed of the requests that finished in it, with the longest
sequence and the longest output always in it, is run through the
reference (the module the configuration's ``reference`` key names) once
each, over the prompt and the served tokens. For each served token the
gap by which its reference logit lies below the reference's best at that
position is read; the number compared is the widest gap over the sample
(``widest_gap``), against the cell's limit in
``bench/limits/<workload>.json``.

The control reads the same positions with the reference computed in the
nearest precision below the configuration's (bf16 -> float8 e4m3 with a
per-tensor scale, every matrix product's operands): the gap of the token
that the control puts first.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.lib import arch

__all__ = ["sample", "gaps", "fp8", "limits"]

SAMPLE_TOKENS = 320   # served tokens the sample reaches at least,
SAMPLE_REQUESTS = 6   # in at least this many requests,
SAMPLE_SEQ_TOKENS = 60000  # and the sequence tokens it stays under


def limits(root: Path, workload: str) -> Dict:
    return json.loads((root / "limits" / f"{workload}.json").read_text())


def sample(done: List, seed: int) -> List:
    """Requests to check, from ``done`` (``(prompt, output)`` pairs that
    finished ok): the longest sequence, the longest output, then others in
    the seed's order until :data:`SAMPLE_TOKENS` served tokens in
    :data:`SAMPLE_REQUESTS` requests, or :data:`SAMPLE_SEQ_TOKENS`
    sequence tokens. (Greedy decoding of random weights can settle into a
    loop whose tokens win by a wide margin; several requests keep the
    sample from resting on one.)"""
    if not done:
        return []
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0xC4EC])
    seq = [len(p) + len(o) for p, o in done]
    order = [int(np.argmax(seq)),
             int(np.argmax([len(o) for _, o in done]))]
    order += [int(i) for i in rng.permutation(len(done))]
    out, seen, served, total = [], set(), 0, 0
    for i in order:
        if i in seen:
            continue
        if out and ((served >= SAMPLE_TOKENS
                     and len(out) >= SAMPLE_REQUESTS)
                    or total + seq[i] > SAMPLE_SEQ_TOKENS):
            break
        seen.add(i)
        out.append(done[i])
        served += len(done[i][1])
        total += seq[i]
    return out


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to 448), back in float32."""
    amax = t.abs().amax().clamp(min=1e-12)
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


def gaps(spec, seed: int, checked: List, device, reference: str,
         control: bool = False) -> Dict[str, Optional[float]]:
    """The widest gap of the served tokens (and, with ``control``, of the
    control's first choices) over ``checked``, by the plain reference of
    the configuration's ``reference`` key (a module path: its
    ``logits_at`` over the weights its ``Weights`` makes)."""
    seqs = []
    for prompt, out in checked:
        toks = torch.as_tensor(np.concatenate(
            [np.asarray(prompt, np.int64), np.asarray(out[:-1], np.int64)]),
            device=device)
        seqs.append((toks, torch.arange(len(prompt) - 1,
                                        len(prompt) - 1 + len(out),
                                        device=device)))
    quants = [lambda t: t] + ([fp8] if control else [])
    mod = arch.load_module(reference)
    res = mod.logits_at(spec, mod.Weights(spec, seed, device), seqs, quants)
    widest, widest_ctl, n = 0.0, 0.0, 0
    for j, (_, out) in enumerate(checked):
        ref = res[0][j]
        served = torch.as_tensor(np.asarray(out, np.int64), device=device)
        best = ref.max(-1).values
        got = ref.gather(1, served[:, None])[:, 0]
        widest = max(widest, float((best - got).max()))
        n += len(out)
        if control:
            pick = res[1][j].argmax(-1)
            widest_ctl = max(widest_ctl, float(
                (best - ref.gather(1, pick[:, None])[:, 0]).max()))
    return {"widest_gap": widest, "served_tokens_checked": n,
            "control_widest_gap": widest_ctl if control else None}
