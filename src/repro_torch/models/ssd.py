"""Mamba-2 SSD mixer (``repro.models.ssd``): mamba2-370m.

Chunked SSD: the sequence is cut into chunks of ``Q`` positions; inside a
chunk the quadratic "attention-like" form runs as einsums, across chunks a
Python loop (the reference's ``lax.scan``) carries the ``(H, N, P)``
state. Decode is the O(1) recurrent step. Every f32 cast of the reference
is kept, as is the ``clip(-60, 0)`` on each log decay.

Caches are ``{"state": (B, H, N, P) f32, "conv": (B, K - 1, C)}`` in the
compute dtype, with a leading L axis in a uniform stack (``layer_idx``
selects the layer). As everywhere in the port, the block writes its cache
**in place** and returns only its output.

Padding positions (segment id 0, prefill only) are identity steps: their
conv input is zeroed and ``dt = 0``, so the recurrence decays by
``exp(0) = 1`` and adds nothing. A right-aligned padded row therefore ends
in the state a solo unpadded prefill of its tokens gives, which is what the
engine's row-per-request prefill gathers into the slot lanes. In decode,
``slot_mask`` freezes the state and conv taps of rows outside it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.factorized import (DictionaryBank, apply_linear,
                                        init_linear)
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import layer_view

__all__ = ["init_ssd", "ssd_block", "init_ssd_cache"]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, H, conv_ch


def _uniform(g: torch.Generator, shape, lo: float, hi: float,
             dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=g.device).uniform_(
        lo, hi, generator=g)


def init_ssd(g: torch.Generator, cfg: ModelConfig,
             bank: Optional[DictionaryBank], lead=()) -> Dict:
    """The reference's ``init_ssd`` with leading dims ``lead``: the
    ``ssd_in`` / ``ssd_out`` projections (dense or factorized), the conv
    taps ``N(0, 1/K)`` and zero bias, ``A_log = log U(1, 16)``, ``dt_bias``
    the inverse softplus of ``U(dt_min, dt_max)``, unit ``D`` and gated-norm
    scale, in the params dtype."""
    s, d_in, H, conv_ch = _dims(cfg)
    d, dt, lead = cfg.d_model, cfg.params_dtype, tuple(lead)
    fcfg = cfg.factorization
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + H  # z, x, B, C, dt
    kw = dict(dtype=dt, lead=lead)
    conv_w = torch.empty(lead + (conv_ch, s.d_conv), dtype=dt,
                         device=g.device).normal_(0.0, 1.0, generator=g)
    dtv = _uniform(g, lead + (H,), s.dt_min, s.dt_max, dt)
    return {
        "in_proj": init_linear(g, d, proj_out, fcfg, bank, "ssd_in", **kw),
        "out_proj": init_linear(g, d_in, d, fcfg, bank, "ssd_out", **kw),
        "conv_w": conv_w / math.sqrt(s.d_conv),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dt, device=g.device),
        "A_log": torch.log(_uniform(g, lead + (H,), 1.0, 16.0, dt)),
        "dt_bias": torch.log(torch.exp(dtv) - 1.0 + 1e-6),
        "D": torch.ones(lead + (H,), dtype=dt, device=g.device),
        "norm_scale": torch.ones(lead + (d_in,), dtype=dt, device=g.device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv from zero taps, then SiLU: x (B, S, C), w (C,
    K). Returns ``(y in x's dtype, the last K - 1 inputs)``."""
    K = w.shape[1]
    state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                        device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, S + K - 1, C)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + xp[:, i:i + x.shape[1]].float() * w[:, i].float()
    y = y + b.float()
    return F.silu(y).to(x.dtype), xp[:, -(K - 1):]


def _heads(t: torch.Tensor, hpg: int, axis: int, H: int) -> torch.Tensor:
    """Group-shared B or C over the heads: head ``h`` reads group ``h //
    hpg`` (the reference's ``repeat``; a broadcast for one group)."""
    if t.shape[axis] > 1:
        return torch.repeat_interleave(t, hpg, dim=axis)
    shape = list(t.shape)
    shape[axis] = H
    return t.expand(shape)


def _ssd_scan(xh: torch.Tensor, a_log: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, chunk: int):
    """Chunked SSD. xh (B, S, H, P) (already ``* dt``); a_log (B, S, H)
    per-step log decay; Bm/Cm (B, S, G, N). Returns y (B, S, H, P) f32 and
    the final state (B, H, N, P) f32. ``S`` must be a multiple of ``Q =
    min(chunk, S)``, as in the reference."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"SSD scan: sequence {S} is no multiple of the "
                         f"chunk {Q}")
    nC, hpg = S // Q, H // G

    def ch(t):  # (B, S, ...) -> (B, nC, Q, ...)
        return t.reshape((Bsz, nC, Q) + tuple(t.shape[2:]))

    x_ = ch(xh).float()
    a_, B_, C_ = ch(a_log).float(), ch(Bm).float(), ch(Cm).float()
    s_cum = torch.cumsum(a_, dim=2)  # (B, nC, Q, H) inclusive log decay
    # Intra-chunk: scores[i, j] = (C_i . B_j) exp(s_i - s_j), i >= j.
    CB = _heads(torch.einsum("bcqgn,bckgn->bcgqk", C_, B_), hpg, 2, H)
    si = s_cum.permute(0, 1, 3, 2)  # (B, nC, H, Q)
    decay = torch.exp(torch.clamp(si[..., :, None] - si[..., None, :],
                                  -60.0, 0.0))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    scores = torch.where(mask, CB * decay, 0.0)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores, x_)
    # Chunk-local end states: sum_j exp(s_Q - s_j) B_j (x) x_j.
    end_decay = torch.exp(torch.clamp(si[..., -1:] - si, -60.0, 0.0))
    xw = x_ * end_decay.permute(0, 1, 3, 2)[..., None]
    states = torch.einsum("bcqhn,bcqhp->bchnp", _heads(B_, hpg, 3, H), xw)
    # Inter-chunk recurrence: a loop over the chunks.
    chunk_decay = torch.exp(torch.clamp(si[..., -1], -60.0, 0.0))  # (B,nC,H)
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xh.device)
    prevs = []
    for c in range(nC):
        prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(prevs, dim=1)  # (B, nC, H, N, P): before chunk c
    # y_inter[i] = C_i . (exp(s_i) h_prev).
    in_decay = torch.exp(torch.clamp(si, -60.0, 0.0)).permute(0, 1, 3, 2)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", _heads(C_, hpg, 3, H),
                           h_prevs) * in_decay[..., None]
    return (y_intra + y_inter).reshape(Bsz, S, H, P), h


def ssd_block(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
              dicts: Optional[Dict] = None,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              layer_idx: Optional[int] = None,
              seg_ids: Optional[torch.Tensor] = None,
              slot_mask: Optional[torch.Tensor] = None,
              sparse_train: bool = False) -> torch.Tensor:
    """The SSD mixer on x (B, S, d): with ``cache`` and ``S == 1`` the
    recurrent decode step (rows outside ``slot_mask`` keep their state),
    otherwise the chunked scan over the sequence, which fills ``cache``
    (when given) with each row's end state and last conv inputs. Then the
    gated RMSNorm ``norm(y * silu(z))`` and the out projection. Returns
    (B, S, d) in the compute dtype."""
    s, d_in, H, _ = _dims(cfg)
    dt_c = cfg.compute_dtype
    # ``sparse_train``: factorized W_D through the STE (training)
    lin_kw = dict(fcfg=cfg.factorization, sparse_train=sparse_train)
    B_, S, _ = x.shape
    G, N, P = s.n_groups, s.d_state, s.head_dim

    zxbcdt = apply_linear(p["in_proj"], x, dicts, "ssd_in",
                          compute_dtype=dt_c, **lin_kw).to(dt_c)
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [d_in, d_in, G * N, G * N, H],
                                    dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    A = -torch.exp(p["A_log"].float())  # (H,) negative
    dt_f = F.softplus(dt.float() + p["dt_bias"].float())  # (B, S, H)
    if seg_ids is not None and S > 1:  # padding: identity steps
        seg_mask = (seg_ids > 0)[..., None]
        conv_in = torch.where(seg_mask, conv_in, torch.zeros((), dtype=dt_c,
                                                            device=x.device))
        dt_f = torch.where(seg_mask, dt_f, 0.0)
    D = p["D"].float()

    if cache is not None and S == 1:
        conv_l = layer_view(cache, "conv", layer_idx)
        state_l = layer_view(cache, "state", layer_idx)
        xp = torch.cat([conv_l, conv_in], dim=1)  # (B, K, C)
        y = torch.einsum("bkc,ck->bc", xp.float(), p["conv_w"].float()) \
            + p["conv_b"].float()
        xs_c, Bm_c, Cm_c = torch.split(F.silu(y), [d_in, G * N, G * N],
                                       dim=-1)
        xh = xs_c.reshape(B_, H, P)
        Bh = _heads(Bm_c.reshape(B_, G, N), H // G, 1, H)
        Ch = _heads(Cm_c.reshape(B_, G, N), H // G, 1, H)
        dts = dt_f[:, 0]  # (B, H)
        h = state_l * torch.exp(dts * A)[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh, xh * dts[..., None])
        yh = torch.einsum("bhn,bhnp->bhp", Ch, h) + D[:, None] * xh
        y_out = yh.reshape(B_, 1, d_in)
        new_conv = xp[:, 1:]
        if slot_mask is not None:
            live = slot_mask.reshape(-1, 1)
            h = torch.where(live[..., None, None], h, state_l)
            new_conv = torch.where(live[:, None], new_conv, conv_l)
        state_l.copy_(h)
        conv_l.copy_(new_conv.to(conv_l.dtype))
    else:
        conv_out, conv_state = _causal_conv(conv_in, p["conv_w"],
                                            p["conv_b"])
        xs_c, Bm_c, Cm_c = torch.split(conv_out, [d_in, G * N, G * N],
                                       dim=-1)
        xh = xs_c.reshape(B_, S, H, P).float()
        y, h_last = _ssd_scan(xh * dt_f[..., None], dt_f * A,
                              Bm_c.reshape(B_, S, G, N),
                              Cm_c.reshape(B_, S, G, N), s.chunk)
        y_out = (y + D[:, None] * xh).reshape(B_, S, d_in)
        if cache is not None:  # prefill fills the recurrent state
            layer_view(cache, "state", layer_idx).copy_(h_last)
            conv_l = layer_view(cache, "conv", layer_idx)
            conv_l.copy_(conv_state.to(conv_l.dtype))

    # Gated RMSNorm (Mamba-2): norm(y * silu(z)), in f32.
    gt = y_out * F.silu(z.float())
    var = (gt * gt).mean(-1, keepdim=True)
    gt = gt * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()
    out = apply_linear(p["out_proj"], gt.to(dt_c), dicts, "ssd_out",
                       compute_dtype=dt_c, **lin_kw)
    return out.to(dt_c)


def init_ssd_cache(cfg: ModelConfig, batch: int, lead=(),
                   device=None) -> Dict[str, torch.Tensor]:
    """Zero SSD caches for ``batch`` rows behind leading dims ``lead``."""
    s, d_in, H, conv_ch = _dims(cfg)
    lead = tuple(lead)
    return {"state": torch.zeros(lead + (batch, H, s.d_state, s.head_dim),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, s.d_conv - 1, conv_ch),
                                dtype=cfg.compute_dtype, device=device)}
