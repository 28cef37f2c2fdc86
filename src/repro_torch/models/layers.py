"""Shared neural layers (``repro.models.layers``, the serving-path parts):
norms, RoPE, the plain flash (prefill) attention, the int8 KV codec, the
attention block (prefill, contiguous decode, paged decode and the mixed
step), the dense decode attention, the SwiGLU FFN, embeddings and logits,
and the init of the attention and FFN linears (dense or factorized through
the family dictionaries).

Layouts match the reference at every public function: ``w`` is ``(d_in,
d_out)``, activations ``(B, S, d)``, queries ``(B, S, Hq, D)``, contiguous
KV lanes ``(L, B, S, Hkv, D)`` and KV page pools ``(L, P, page_size, Hkv,
D)`` (int8 lanes add ``k_scale``/``v_scale`` leaves without the last
axis). Unlike the reference's pure functions, the attention block writes
this step's K/V into the cache **in place** (the cache is the engine's
only copy of it).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.factorized import (DictionaryBank, apply_linear,
                                        init_linear)
from repro_torch.kernels.common import resolve_decode_attn
from repro_torch.kernels.tda.ops import (
    fused_decode_attention,
    fused_mixed_attention,
    gather_paged_lanes,
)
from repro_torch.models.common import ModelConfig

NEG_INF = -1e30

__all__ = ["apply_norm", "rope_tables", "apply_rope", "flash_attention",
           "kv_quantize", "kv_dequantize", "decode_attention",
           "init_attention", "attention_block", "init_ffn", "ffn_block",
           "embed_tokens", "lm_logits", "NEG_INF"]


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (or LayerNorm when ``p`` has a bias) in f32, ``* scale``
    (no ``1 +``), cast back to ``x.dtype``."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions: ``(..., dim // 2)`` f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D // 2). Rotates interleaved
    (even, odd) pairs — not the half-split ``rotate_half`` layout."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    seg_q: Optional[torch.Tensor] = None,
                    seg_kv: Optional[torch.Tensor] = None,
                    chunk: int = 512) -> torch.Tensor:
    """Masked attention of the prefill (``layers.flash_attention``, which
    the reference writes in jnp): q (B, Sq, Hq, D) against k/v (B, Skv,
    Hkv, D), GQA. Query ``i`` sits at kv position ``i + Skv - Sq`` and sees
    key ``j`` when both carry the same nonzero segment id (``None``: all
    ones), ``j <= i`` (``causal``) and ``i - j < window``. Scores and the
    softmax are f32, over query blocks of ``chunk`` rows so the score
    tensor stays bounded. A query with no visible key (padding) gets the
    mean of ``v``. Returns ``q.dtype``."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    if seg_q is None:
        seg_q = torch.ones((B, Sq), dtype=torch.int32, device=dev)
    if seg_kv is None:
        seg_kv = torch.ones((B, Skv), dtype=torch.int32, device=dev)
    kf, vf = k.float(), v.float()
    ik = torch.arange(Skv, device=dev)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    for a in range(0, Sq, chunk):
        b = min(a + chunk, Sq)
        qg = q[:, a:b].float().reshape(B, b - a, Hkv, G, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * (1.0 / math.sqrt(D))
        sq = seg_q[:, a:b]
        m = (sq[:, :, None] == seg_kv[:, None, :]) & (sq[:, :, None] > 0)
        iq = torch.arange(a, b, device=dev) + (Skv - Sq)
        if causal:
            m &= (iq[:, None] >= ik[None, :])[None]
        if window is not None:
            m &= ((iq[:, None] - ik[None, :]) < window)[None]
        s = torch.where(m[:, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        out[:, a:b] = o.reshape(B, b - a, Hq, D).to(q.dtype)
    return out


def kv_quantize(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H, D) -> int8 codes and per-(token, head) f32 scales, the
    serving KV layout: ``scale = (amax + 1e-6) / 127``, codes rounded half
    to even and clipped to +-127."""
    tf = t.float()
    scale = (tf.abs().amax(dim=-1) + 1e-6) / 127.0
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_index, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense single-token attention (``layers.decode_attention``'s jnp
    path): q (B, 1, Hq, D) against contiguous lanes (B, S, Hkv, D) — or
    int8 codes with ``k_scale``/``v_scale`` (B, S, Hkv), dequantized in f32
    first — valid positions ``< cache_index``. Rows with no valid position
    get the masked softmax's uniform average, as in the reference; the
    engine discards them."""
    if k_scale is not None:
        k_cache = k_cache.float() * k_scale[..., None]
        v_cache = v_cache.float() * v_scale[..., None]
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    idx = torch.as_tensor(cache_index, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < idx
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def _write_pool(pool: torch.Tensor, phys: torch.Tensor,
                new: torch.Tensor) -> None:
    """``pool.view(P * ps, ...)[phys] = new`` for in-range ``phys`` only:
    out-of-range entries (inactive rows, unwritten columns, the FREE
    sentinel) are dropped, as the reference's ``mode="drop"`` scatter
    drops them (``index_put_`` would raise instead)."""
    P, ps = pool.shape[0], pool.shape[1]
    flat = pool.view((P * ps,) + tuple(pool.shape[2:]))
    keep = (phys >= 0) & (phys < P * ps)
    flat[phys[keep]] = new[keep].to(pool.dtype)


def _kv_leaves(k: torch.Tensor, v: torch.Tensor,
               quant: bool) -> Dict[str, torch.Tensor]:
    """The cache leaves one step writes: K/V as they are, or int8 codes
    and their scales."""
    if not quant:
        return {"k": k, "v": v}
    out = {}
    out["k"], out["k_scale"] = kv_quantize(k)
    out["v"], out["v_scale"] = kv_quantize(v)
    return out


def init_attention(g: torch.Generator, cfg: ModelConfig,
                   bank: Optional[DictionaryBank], lead=(),
                   prefix: str = "attn") -> Dict:
    """``wq``/``wk``/``wv``/``wo`` with leading dims ``lead``, each dense or
    factorized through the ``{prefix}_q`` ... ``{prefix}_o`` dictionary."""
    d, hd, fcfg = cfg.d_model, cfg.head_dim, cfg.factorization
    kw = dict(dtype=cfg.params_dtype, lead=lead)
    return {
        "wq": init_linear(g, d, cfg.n_heads * hd, fcfg, bank, f"{prefix}_q",
                          use_bias=cfg.qkv_bias, **kw),
        "wk": init_linear(g, d, cfg.kv_heads * hd, fcfg, bank, f"{prefix}_k",
                          use_bias=cfg.qkv_bias, **kw),
        "wv": init_linear(g, d, cfg.kv_heads * hd, fcfg, bank, f"{prefix}_v",
                          use_bias=cfg.qkv_bias, **kw),
        "wo": init_linear(g, cfg.n_heads * hd, d, fcfg, bank, f"{prefix}_o",
                          **kw),
    }


def attention_block(
    p: Dict,
    x: torch.Tensor,                  # (B, S, d)
    *,
    cfg: ModelConfig,
    dicts: Optional[Dict] = None,     # params["dicts"] (factorized weights)
    positions: torch.Tensor,          # (B, S) positions (RoPE)
    cache: Optional[Dict[str, torch.Tensor]] = None,  # L-stacked leaves
    layer_idx: int = 0,
    cache_index: Optional[torch.Tensor] = None,  # (B,) tokens resident
    pages: Optional[Dict] = None,     # {"bt": (B, n), "width", "page_size"}
    slot_mask: Optional[torch.Tensor] = None,  # (B,) bool writable rows
    n_new: Optional[torch.Tensor] = None,      # (B,): mixed step
    seg_ids: Optional[torch.Tensor] = None,    # (B, S): prefill packing
) -> torch.Tensor:
    """GQA attention with RoPE, in the four forms the serving paths take:

    * **prefill** (no ``cache_index``): :func:`flash_attention` over the
      unquantized K/V with segment ids, then, when ``cache`` is given, the
      K/V (int8 codes and scales with ``kv_quant``) written at lane
      positions ``[0, S)`` of contiguous caches ``(L, B, S_max, Hkv, D)``;
    * **contiguous decode** (``cache_index``, no ``pages``, S == 1): the
      token is written at ``(b, cache_index[b])`` for the rows in
      ``slot_mask``, then attended;
    * **paged decode** (``pages``, S == 1): the same through the block
      table into page pools ``(L, P, page_size, Hkv, D)``;
    * **mixed step** (``n_new`` given, paged, unquantized): row b's
      columns ``[0, n_new[b])`` are fresh tokens at ``[cache_index,
      cache_index + n_new)``; queries attend the PRE-write lane plus the
      causal in-row chunk, and only then does the chunk scatter into the
      pool.
    """
    B, S, _ = x.shape
    hd = cfg.head_dim
    dt = cfg.compute_dtype

    def lin(name, inp, fam):
        return apply_linear(p[name], inp, dicts, fam, compute_dtype=dt).to(dt)

    q = lin("wq", x, "attn_q").reshape(B, S, cfg.n_heads, hd)
    k = lin("wk", x, "attn_k").reshape(B, S, cfg.kv_heads, hd)
    v = lin("wv", x, "attn_v").reshape(B, S, cfg.kv_heads, hd)
    if cfg.rope:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    quant = cache is not None and "k_scale" in cache
    impl = resolve_decode_attn(cfg.decode_attn, x.device)
    if cache_index is None:
        o = flash_attention(q, k, v, causal=cfg.causal, seg_q=seg_ids,
                            seg_kv=seg_ids, chunk=cfg.attn_chunk)
        if cache is not None:
            for name, t in _kv_leaves(k, v, quant).items():
                cache[name][layer_idx, :, :S] = t.to(cache[name].dtype)
        return lin("wo", o.reshape(B, S, cfg.n_heads * hd), "attn_o")

    ci = cache_index.reshape(-1).to(torch.int64).expand(B)
    if n_new is not None:
        if quant:
            raise ValueError("the mixed step takes unquantized lanes "
                             "(EngineConfig refuses mixed with kv_quant)")
        ps = pages["page_size"]
        ringw = pages["width"]
        bt = pages["bt"]
        kpool, vpool = cache["k"][layer_idx], cache["v"][layer_idx]
        P = kpool.shape[0]
        nn = n_new.reshape(-1).to(torch.int64)
        if slot_mask is not None:
            sm = slot_mask.reshape(-1)
            ci = torch.where(sm, ci, 0)
            nn = torch.where(sm, nn, 0)  # inert row: attends, writes nothing
        o = fused_mixed_attention(q, kpool, vpool, k, v, ci, nn,
                                  block_table=bt, ring=ringw,
                                  use_kernel=impl == "tda")
        # Chunk scatter AFTER attention: token j lands at lane position
        # (ci + j) % ringw; only the last min(n_new, ringw) columns write
        # (earlier columns of a wrapping chunk alias the same position).
        cols = torch.arange(S, device=x.device)[None, :]
        lanepos = (ci[:, None] + cols) % ringw
        wvalid = (cols < nn[:, None]) & (cols >= nn[:, None] - ringw)
        page = torch.gather(bt.long(), 1, lanepos // ps)
        phys = torch.where(wvalid, page * ps + lanepos % ps, P * ps)
        _write_pool(kpool, phys.reshape(-1), k.reshape(B * S, *k.shape[2:]))
        _write_pool(vpool, phys.reshape(-1), v.reshape(B * S, *v.shape[2:]))
        return lin("wo", o.reshape(B, S, cfg.n_heads * hd), "attn_o")

    if S != 1:
        raise ValueError("decode takes one token per row")
    new = _kv_leaves(k[:, 0], v[:, 0], quant)
    lanes = {name: cache[name][layer_idx] for name in new}
    if pages is not None:
        ps = pages["page_size"]
        bt = pages["bt"]
        P = lanes["k"].shape[0]
        page = torch.gather(bt.long(), 1, (ci // ps)[:, None])[:, 0]
        phys = page * ps + ci % ps
        if slot_mask is not None:
            phys = torch.where(slot_mask.reshape(-1), phys, P * ps)
        for name, t in new.items():
            _write_pool(lanes[name], phys, t)
    else:
        # In place at (b, cache_index[b]) for the writable rows; an index
        # past the lane writes nothing, as the reference's one-hot select.
        # Other rows write their own value back (one distinct position per
        # row, and no host sync to find the writable ones).
        W = lanes["k"].shape[1]
        keep = (ci >= 0) & (ci < W)
        if slot_mask is not None:
            keep &= slot_mask.reshape(-1)
        rows = torch.arange(B, device=x.device)
        pos = torch.clamp(ci, 0, W - 1)
        for name, t in new.items():
            lane = lanes[name]
            old = lane[rows, pos]
            keep_b = keep.reshape((B,) + (1,) * (old.dim() - 1))
            lane[rows, pos] = torch.where(keep_b, t.to(lane.dtype), old)
    if slot_mask is not None:
        ci = torch.where(slot_mask.reshape(-1), ci, -1)
    hi = ci + 1  # inactive rows: hi == 0, nothing attended
    bt = pages["bt"] if pages is not None else None
    if impl == "tda":
        o = fused_decode_attention(q, lanes["k"], lanes["v"], hi,
                                   k_scale=lanes.get("k_scale"),
                                   v_scale=lanes.get("v_scale"),
                                   block_table=bt)
    else:
        def view(name):
            t = lanes[name]
            return t if bt is None else gather_paged_lanes(t, bt)

        if quant:
            kc = kv_dequantize(view("k"), view("k_scale"), dt)
            vc = kv_dequantize(view("v"), view("v_scale"), dt)
        else:
            kc, vc = view("k"), view("v")
        o = decode_attention(q, kc, vc, hi)
    return lin("wo", o.reshape(B, S, cfg.n_heads * hd), "attn_o")


def init_ffn(g: torch.Generator, cfg: ModelConfig,
             bank: Optional[DictionaryBank], lead=(),
             prefix: str = "ffn") -> Dict:
    """SwiGLU ``w_up``/``w_down``/``w_gate`` with leading dims ``lead``,
    each dense or factorized through its ``{prefix}_*`` dictionary."""
    d, f, fcfg = cfg.d_model, cfg.d_ff, cfg.factorization
    kw = dict(dtype=cfg.params_dtype, lead=lead)
    return {"w_up": init_linear(g, d, f, fcfg, bank, f"{prefix}_up", **kw),
            "w_down": init_linear(g, f, d, fcfg, bank, f"{prefix}_down", **kw),
            "w_gate": init_linear(g, d, f, fcfg, bank, f"{prefix}_gate", **kw)}


def ffn_block(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
              dicts: Optional[Dict] = None) -> torch.Tensor:
    """SwiGLU FFN: ``w_down(silu(w_gate x) * w_up x)``."""
    dt = cfg.compute_dtype
    if cfg.act != "swiglu":
        raise ValueError(f"only the swiglu FFN is ported, got {cfg.act!r}")

    def lin(name, inp, fam):
        return apply_linear(p[name], inp, dicts, fam, compute_dtype=dt).to(dt)

    up = lin("w_up", x, "ffn_up")
    h = F.silu(lin("w_gate", x, "ffn_gate")) * up
    return lin("w_down", h, "ffn_down")


def embed_tokens(p: Dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return p["tok"][tokens.long()].to(cfg.compute_dtype)


def lm_logits(p_head: Dict, p_embed: Dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """f32 logits ``x @ w`` (tied: ``x @ tok.T``)."""
    xf = x.float()
    if cfg.tie_embeddings:
        return xf @ p_embed["tok"].float().T
    return xf @ p_head["w"].float()
