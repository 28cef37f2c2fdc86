"""Plain reference of the decoder stacks the benchmark serves (qwen2.5 and
starcoder2): one full forward in float32 over a whole sequence, no cache,
no batching, no kernels, TF32 off.

A layer is ``x + attn(norm1(x))`` then ``x + ffn(norm2(x))``; RMSNorm or
LayerNorm (the configuration's eps, the scale multiplies, no ``1 +``); q, k, v with their
biases, RoPE on interleaved (even, odd) pairs, grouped-query attention
(query head ``h`` reads kv head ``h // G``) with the causal mask and, for a
windowed stack, ``i - j < window``; SwiGLU ``down(silu(gate x) * up x)`` or
``down(gelu_tanh(up x))``; the final norm and the head in float32.
Departures from the published models, as the program runs them: no bias
on ``o`` or the FFN (starcoder2 publishes them), eps 1e-6 where
starcoder2 publishes 1e-5.

Weights come from :class:`Weights`, which this module passes on to the
harness (``bench/reference/trex.py`` derives the compressed streams'
values again from the raw draws). ``quant`` turns every matrix product's
operands into that lower precision (the control). Imports neither the
program nor JAX.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from bench.reference.trex import Weights

__all__ = ["logits_at", "Weights", "Q_BLOCK"]

Q_BLOCK = 512  # query rows per attention block


def _norm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    if "bias" in p:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"]


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D), positions 0 .. T-1."""
    T, _, D = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], -1).reshape(
        x.shape)


def _attend(q, k, v, window: Optional[int], quant) -> torch.Tensor:
    """q (T, Hq, D), k / v (T, Hkv, D) -> (T, Hq * D)."""
    T, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    out = torch.empty((T, Hq, D), dtype=torch.float32, device=q.device)
    ik = torch.arange(T, device=q.device)
    kq, vq = quant(k), quant(v)
    for a in range(0, T, Q_BLOCK):
        b = min(a + Q_BLOCK, T)
        lo = 0 if window is None else max(0, a - window + 1)
        qg = quant(q[a:b]).reshape(b - a, Hkv, G, D)
        s = torch.einsum("qhgd,khd->hgqk", qg, kq[lo:b]) / math.sqrt(D)
        iq = torch.arange(a, b, device=q.device)
        m = iq[:, None] >= ik[None, lo:b]
        if window is not None:
            m &= (iq[:, None] - ik[None, lo:b]) < window
        p = torch.softmax(s.masked_fill(~m, float("-inf")), -1)
        o = torch.einsum("hgqk,khd->qhgd", quant(p), vq[lo:b])
        out[a:b] = o.reshape(b - a, Hq, D)
    return out.reshape(T, Hq * D)


def _linear(w, x: torch.Tensor, quant) -> torch.Tensor:
    """``w``: ``{"w"}`` dense, or ``{"ws", "wd"}`` factorized (the product
    in the program's order, ``(x @ W_S) @ W_D``), plus ``"b"``."""
    if "w" in w:
        y = quant(x) @ quant(w["w"])
    else:
        y = quant(quant(x) @ quant(w["ws"])) @ quant(w["wd"])
    return y + w["b"] if "b" in w else y


def logits_at(spec, weights, seqs: List, quants: List[Callable]
              ) -> List[List[torch.Tensor]]:
    """Float32 logits of each sequence's wanted positions, for each
    precision: ``out[i][j]`` is ``(len(rows_j), V)`` for ``seqs[j] =
    (tokens (T,), rows)`` under ``quants[i]`` (``lambda t: t`` for the
    reference itself). Each layer's weights are made once from
    ``weights`` (:class:`~bench.reference.trex.Weights`) and applied to
    every sequence and precision before the next layer is made."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _forward(spec, weights, seqs, quants)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _layer(spec, lw, x, quant):
    hd, T = spec.head_dim, x.shape[0]
    h = _norm(lw["norm1"], x, spec.norm_eps)
    q = _linear(lw["wq"], h, quant).reshape(T, spec.heads, hd)
    k = _linear(lw["wk"], h, quant).reshape(T, spec.kv_heads, hd)
    v = _linear(lw["wv"], h, quant).reshape(T, spec.kv_heads, hd)
    q, k = _rope(q, spec.rope_theta), _rope(k, spec.rope_theta)
    x = x + _linear(lw["wo"], _attend(q, k, v, spec.window, quant), quant)
    del q, k, v
    h = _norm(lw["norm2"], x, spec.norm_eps)
    up = _linear(lw["w_up"], h, quant)
    if spec.act == "swiglu":
        act = F.silu(_linear(lw["w_gate"], h, quant)) * up
    else:
        act = F.gelu(up, approximate="tanh")
    del up, h
    return x + _linear(lw["w_down"], act, quant)


def _forward(spec, weights, seqs, quants):
    emb = weights.embed()
    xs = [[emb[t.long()] for t, _ in seqs] for _ in quants]
    del emb
    for li in range(spec.layers):
        lw = weights.layer(li)
        xs = [[_layer(spec, lw, x, qf) for x in row]
              for row, qf in zip(xs, quants)]
        del lw
    fn, head = weights.final_norm(), weights.head()
    return [[qf(_norm(fn, x[r.long()], spec.norm_eps)) @ qf(head)
             for x, (_, r) in zip(row, seqs)]
            for row, qf in zip(xs, quants)]
