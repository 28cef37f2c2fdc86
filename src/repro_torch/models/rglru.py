"""Griffin RG-LRU recurrent block (``repro.models.rglru``):
recurrentgemma-2b.

Block: ``x -> [GeLU(x W_y)] * [x W_x -> causal conv1d -> RG-LRU] -> W_out``
with the recurrence

    r_t = sigmoid(u_t W_a + b_a),  i_t = sigmoid(u_t W_i + b_i)
    a_t = exp(-8 softplus(lambda) r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

in f32. Over a sequence the linear recurrence ``h_t = a_t h_{t-1} + b_t``
runs as :func:`associative_scan`, the reference's ``lax.associative_scan``
written out with the same pairing (log2(S) levels of a few tensor ops each,
never a loop over tokens); one decode token is the O(1) step.

Caches are ``{"h": (B, w) f32, "conv": (B, K - 1, w)}`` in the compute
dtype (a leading L axis in a uniform stack, selected by ``layer_idx``),
written in place. Padding positions (segment id 0, prefill only) are
identity steps: conv input zeroed, ``(a, b) = (1, 0)``, so a right-aligned
padded row ends in its solo state; in decode ``slot_mask`` freezes the
rows outside it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.factorized import (DictionaryBank, apply_linear,
                                        init_linear)
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import layer_view

__all__ = ["init_rglru", "rglru_block", "init_rglru_cache",
           "associative_scan"]


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def init_rglru(g: torch.Generator, cfg: ModelConfig,
               bank: Optional[DictionaryBank], lead=()) -> Dict:
    """The reference's ``init_rglru`` with leading dims ``lead``: the
    ``rglru_y`` / ``rglru_x`` / ``rglru_out`` projections (dense or
    factorized), conv taps ``N(0, 1/K)`` and zero bias, the gates ``w_a``
    and ``w_i`` ``N(0, 1/w)`` (the reference draws both from one key, so
    they are equal; so are they here) with zero biases, and ``lambda``
    such that ``a`` is ``U(0.9, 0.999)`` at ``r = 1``."""
    d, w, rg = cfg.d_model, _width(cfg), cfg.rglru
    dt, lead, fcfg = cfg.params_dtype, tuple(lead), cfg.factorization
    kw = dict(dtype=dt, lead=lead)

    def normal(shape, std):
        return torch.empty(lead + shape, dtype=dt, device=g.device).normal_(
            0.0, std, generator=g)

    p = {"w_y": init_linear(g, d, w, fcfg, bank, "rglru_y", **kw),
         "w_x": init_linear(g, d, w, fcfg, bank, "rglru_x", **kw),
         "w_out": init_linear(g, w, d, fcfg, bank, "rglru_out", **kw),
         "conv_w": normal((w, rg.conv_width), 1.0 / math.sqrt(rg.conv_width))}
    u = torch.empty(lead + (w,), dtype=torch.float32,
                    device=g.device).uniform_(0.9, 0.999, generator=g)
    w_a = normal((w, w), 1.0 / math.sqrt(w))
    zeros = torch.zeros(lead + (w,), dtype=dt, device=g.device)
    p.update({"conv_b": zeros.clone(), "w_a": w_a, "b_a": zeros.clone(),
              "w_i": w_a.clone(), "b_i": zeros.clone(),
              "lambda": torch.log(torch.exp(-torch.log(u) / rg.c_exponent)
                                  - 1.0 + 1e-8).to(dt)})
    return p


def _gates(p: Dict, u: torch.Tensor):
    """u (..., w) conv output -> ``(a, b)`` of ``h = a h_prev + b``, f32."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(uf @ p["w_i"].float() + p["b_i"].float())
    log_a = -8.0 * F.softplus(p["lambda"].float()) * r
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0)) \
        * (i * uf)
    return torch.exp(log_a), b


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv (no activation): x (B, S, w), w (w, K), from
    ``state`` (B, K - 1, w) or zero taps. Returns ``(y in x's dtype, the
    last K - 1 inputs)``."""
    K = w.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + xp[:, i:i + x.shape[1]].float() * w[:, i].float()
    return (y + b.float()).to(x.dtype), xp[:, -(K - 1):]


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     axis: int = 1) -> List[torch.Tensor]:
    """Inclusive scan of ``elems`` along ``axis`` under the associative
    ``fn(earlier, later)``: ``jax.lax.associative_scan`` (forward), with
    its recursion and pairing, so f32 results follow the same order of
    operations. Depth log2(S); every level is a few whole-tensor ops."""
    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    def interleave(a, b):  # a[0], b[0], a[1], b[1], ... (len a >= len b)
        na, nb = a.shape[axis], b.shape[axis]
        if nb < na:  # pad b by one to interleave, then drop the pad
            b = torch.cat([b, sl(a, 0, 1)], dim=axis)
        out = torch.stack([a, b], dim=axis + 1)
        shape = list(a.shape)
        shape[axis] = 2 * na
        return sl(out.reshape(shape), 0, na + nb)

    def scan(es):
        n = es[0].shape[axis]
        if n < 2:
            return list(es)
        reduced = fn([sl(e, 0, -1, 2) for e in es],
                     [sl(e, 1, None, 2) for e in es])
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn([sl(e, 0, -1) for e in odd],
                      [sl(e, 2, None, 2) for e in es])
        else:
            even = fn(odd, [sl(e, 2, None, 2) for e in es])
        even = [torch.cat([sl(e, 0, 1), r], dim=axis)
                for e, r in zip(es, even)]
        return [interleave(e, o) for e, o in zip(even, odd)]

    return scan(list(elems))


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return [a1 * a2, a2 * b1 + b2]


def rglru_block(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
                dicts: Optional[Dict] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                layer_idx: Optional[int] = None,
                seg_ids: Optional[torch.Tensor] = None,
                slot_mask: Optional[torch.Tensor] = None,
                sparse_train: bool = False) -> torch.Tensor:
    """The RG-LRU block on x (B, S, d): with ``cache`` and ``S == 1`` the
    decode step (rows outside ``slot_mask`` frozen), otherwise the scan
    over the sequence, which fills ``cache`` (when given) with each row's
    last ``h`` and conv inputs. Returns (B, S, d) in the compute dtype."""
    dt = cfg.compute_dtype
    S = x.shape[1]
    # ``sparse_train``: factorized W_D through the STE (training)
    lin_kw = dict(fcfg=cfg.factorization, sparse_train=sparse_train)
    y_gate = F.gelu(apply_linear(p["w_y"], x, dicts, "rglru_y",
                                 compute_dtype=dt, **lin_kw).float(),
                    approximate="tanh")
    u = apply_linear(p["w_x"], x, dicts, "rglru_x", compute_dtype=dt,
                     **lin_kw).to(dt)
    seg_mask = None
    if seg_ids is not None and S > 1:  # padding: identity steps
        seg_mask = (seg_ids > 0)[..., None]
        u = torch.where(seg_mask, u, torch.zeros((), dtype=dt,
                                                 device=x.device))
    if cache is not None and S == 1:
        h_l = layer_view(cache, "h", layer_idx)
        c_l = layer_view(cache, "conv", layer_idx)
        conv_out, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], c_l)
        a, b = _gates(p, conv_out[:, 0])
        h = a * h_l + b  # (B, w)
        if slot_mask is not None:
            live = slot_mask.reshape(-1, 1)
            h = torch.where(live, h, h_l)
            new_conv = torch.where(live[:, None], new_conv, c_l)
        h_l.copy_(h)
        c_l.copy_(new_conv.to(c_l.dtype))
        ht = h[:, None]
    else:
        conv_out, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"])
        a, b = _gates(p, conv_out)  # (B, S, w)
        if seg_mask is not None:
            a = torch.where(seg_mask, a, 1.0)
            b = torch.where(seg_mask, b, 0.0)
        ht = associative_scan(_combine, (a, b), axis=1)[1]  # h_0 = 0
        if cache is not None:
            h_l = layer_view(cache, "h", layer_idx)
            c_l = layer_view(cache, "conv", layer_idx)
            h_l.copy_(ht[:, -1])
            c_l.copy_(conv_state.to(c_l.dtype))
    out = apply_linear(p["w_out"], (ht * y_gate).to(dt), dicts, "rglru_out",
                       compute_dtype=dt, **lin_kw)
    return out.to(dt)


def init_rglru_cache(cfg: ModelConfig, batch: int, lead=(),
                     device=None) -> Dict[str, torch.Tensor]:
    """Zero RG-LRU caches for ``batch`` rows behind leading dims ``lead``."""
    w, lead = _width(cfg), tuple(lead)
    return {"h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, cfg.rglru.conv_width - 1, w),
                                dtype=cfg.compute_dtype, device=device)}
