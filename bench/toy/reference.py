"""Plain reference of the toy architecture (``bench/toy/arch.py``): one
full forward in float32 over a whole sequence, no cache, no batching, no
kernels, TF32 off. A layer is ``x + attn(norm1(x))`` then ``x +
moe(norm2(x))``: the dense decoder's RMSNorm, RoPE and grouped-query
attention (``bench/reference/decoder.py``), windowed on the local layers;
the router's softmax over the experts, the ``k`` best (the lower index
first among equals) with their scores renormalized to sum 1, each
token's output the scores' sum of its experts' SwiGLU ``down(silu(gate
h) * up h)``. No claim drops (the configuration's capacity admits every
token). Imports nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from bench.lib.weights import make_leaf
from bench.reference.decoder import _attend, _norm, _rope
from bench.toy.arch import leaf_specs

__all__ = ["Weights", "logits_at"]


class Weights:
    """Float32 weights of ``spec`` for seed ``seed`` on ``device``, one
    layer at a time."""

    def __init__(self, spec, seed: int, device):
        self.spec, self.seed, self.device = spec, seed, device
        self.leaves = {"/".join(lf[0]): lf for lf in leaf_specs(spec)}

    def _get(self, path: str) -> torch.Tensor:
        return make_leaf(self.spec, self.seed, self.leaves[path],
                         self.device).float()

    def embed(self) -> torch.Tensor:
        return self._get("embed/tok")

    def head(self) -> torch.Tensor:
        return self._get("lm_head/w")

    def layer(self, li: int) -> Dict[str, torch.Tensor]:
        """``{"attn/wq/w": ..., "moe/router": ..., ...}``"""
        pre = f"layers/layer_{li:02d}/"
        return {k[len(pre):]: self._get(k) for k in self.leaves
                if k.startswith(pre)}


def _moe(spec, lw, h: torch.Tensor, quant) -> torch.Tensor:
    probs = torch.softmax(quant(h) @ quant(lw["moe/router"]), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :spec.top_k], idx[:, :spec.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(h)
    for e in range(spec.experts):
        rows = (idx == e).any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        x = quant(h[rows])
        act = F.silu(x @ quant(lw["moe/w_gate/w"][e])) \
            * (x @ quant(lw["moe/w_up/w"][e]))
        y = quant(act) @ quant(lw["moe/w_down/w"][e])
        out[rows] += (gates * (idx == e))[rows].sum(-1, keepdim=True) * y
    return out


def _layer(spec, lw, kind: str, x: torch.Tensor, quant) -> torch.Tensor:
    T, hd = x.shape[0], spec.head_dim
    h = _norm({"scale": lw["norm1/scale"]}, x, spec.norm_eps)
    q, k, v = ((quant(h) @ quant(lw[f"attn/{n}/w"])).reshape(T, -1, hd)
               for n in ("wq", "wk", "wv"))
    q, k = _rope(q, spec.rope_theta), _rope(k, spec.rope_theta)
    o = _attend(q, k, v, spec.window if kind == "local" else None, quant)
    x = x + quant(o) @ quant(lw["attn/wo/w"])
    h = _norm({"scale": lw["norm2/scale"]}, x, spec.norm_eps)
    return x + _moe(spec, lw, h, quant)


def logits_at(spec, weights: Weights, seqs: List, quants: List[Callable]
              ) -> List[List[torch.Tensor]]:
    """As ``bench/reference/decoder.py``'s ``logits_at``: ``out[i][j]``,
    the float32 logits of ``seqs[j] = (tokens, rows)`` at its rows under
    ``quants[i]``."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            emb = weights.embed()
            xs = [[emb[t.long()] for t, _ in seqs] for _ in quants]
            for li, kind in enumerate(spec.kinds):
                lw = weights.layer(li)
                xs = [[_layer(spec, lw, kind, x, qf) for x in row]
                      for row, qf in zip(xs, quants)]
            scale = {"scale": weights._get("final_norm/scale")}
            head = weights.head()
            return [[qf(_norm(scale, x[r.long()], spec.norm_eps)) @ qf(head)
                     for x, (_, r) in zip(row, seqs)]
                    for row, qf in zip(xs, quants)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
