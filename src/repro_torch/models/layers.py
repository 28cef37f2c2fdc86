"""Shared neural layers (``repro.models.layers``, the serving-path parts):
norms (RMSNorm, LayerNorm with bias), RoPE, the plain flash (prefill)
attention (its probability-block dtype and causal wedge), the int8 KV
codec, the attention block (prefill, contiguous decode, paged decode and
the mixed step; full or sliding-window ring lanes; cross-attention over an
encoder's memory), the dense decode attention, the FFN (SwiGLU, GeGLU or
plain tanh GELU), embeddings (tokens, learned positions) and logits, and
the init of the norms and of the
attention and FFN linears (dense or factorized through the family
dictionaries).

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
from torch.utils.checkpoint import checkpoint

from repro_torch.core.factorized import (DictionaryBank, apply_linear,
                                        init_linear, parallel_linear)
from repro_torch.kernels.common import resolve_decode_attn
from repro_torch.kernels.tda.ops import (
    fused_decode_attention,
    fused_mixed_attention,
    gather_paged_lanes,
)
from repro_torch.kernels.tda.sharded import check_head_split
from repro_torch.launch.mesh import (all_to_all, copy_to, gather_from,
                                     reduce_from, scatter_to,
                                     tensor_parallel_size)
from repro_torch.launch.sharding import dp_axes, spec_axes
from repro_torch.models.common import ModelConfig, torch_dtype

NEG_INF = -1e30

__all__ = ["init_norm", "apply_norm", "rope_tables", "apply_rope", "flash_attention",
           "kv_quantize", "kv_dequantize", "decode_attention",
           "init_attention", "attention_block", "init_ffn", "ffn_block",
           "init_embedding", "init_lm_head", "take_rows", "embed_tokens",
           "lm_logits",
           "cross_entropy", "chunked_xent", "layer_view", "NEG_INF"]


def init_norm(cfg: ModelConfig, lead=(),
              device=None) -> Dict[str, torch.Tensor]:
    """Unit ``scale`` (and, for ``norm="layernorm"``, a zero ``bias``) of
    ``d_model`` entries with leading dims ``lead``, in the params dtype."""
    shape = tuple(lead) + (cfg.d_model,)
    p = {"scale": torch.ones(shape, dtype=cfg.params_dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=cfg.params_dtype, device=device)
    return p


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
                    chunk: int = 512, block_dtype=torch.float32,
                    wedge: bool = False) -> torch.Tensor:
    """Masked attention of the prefill (``layers.flash_attention``, which
    the reference writes in jnp): q (B, Sq, Hq, D) against k/v (B, Skv,
    Hkv, D), GQA. Query ``i`` sits at kv position ``i + Skv - Sq`` and sees
    key ``j`` when both carry the same nonzero segment id (``None``: all
    ones), ``j <= i`` (``causal``) and ``i - j < window``. Without
    ``causal`` or a window every query sees every key of its segment,
    whatever ``Sq`` and ``Skv`` are (cross-attention). Scores and the
    softmax are f32, over query blocks of ``chunk`` rows so the score
    tensor stays bounded. A query with no visible key (a pad row or column)
    gets what the reference's online softmax gives it (:func:`_dead_rows`).
    Returns ``q.dtype``.

    ``block_dtype`` other than f32: the reference's online softmax over
    key chunks, step for step (:func:`_flash_online`), so the probability
    blocks are rounded to that dtype before the PV product from the same
    running maxima; the statistics and the accumulator stay f32.

    ``wedge`` (the reference's causal wedge: taken only when ``causal``,
    no window, ``Sq == Skv`` and more than two query chunks): each query
    block scores only the keys ``[0, b)`` its causal mask can reach,
    about half the score work of the masked grid."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    if seg_q is None:
        seg_q = torch.ones((B, Sq), dtype=torch.int32, device=dev)
    if seg_kv is None:
        seg_kv = torch.ones((B, Skv), dtype=torch.int32, device=dev)
    c = min(chunk, Sq, Skv)
    wedge = wedge and causal and window is None and Sq == Skv \
        and -(-Sq // c) > 2
    if block_dtype != torch.float32:
        return _flash_online(q, k, v, causal=causal, window=window,
                             seg_q=seg_q, seg_kv=seg_kv, c=c,
                             block_dtype=block_dtype, wedge=wedge)
    kf, vf = k.float(), v.float()
    ik = torch.arange(Skv, device=dev)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    if wedge:  # c == chunk here: the query blocks are the reference's
        reach = _wedge_reach(-(-Sq // c))
        pad = torch.zeros((B, len(reach) * c - Skv) + tuple(vf.shape[2:]),
                          dtype=vf.dtype, device=dev)
        csum = torch.cat([vf, pad], 1).reshape(
            B, len(reach), c, *vf.shape[2:]).sum(2).cumsum(1)
    else:
        dead_o = _dead_rows(vf, Sq, chunk, window)  # (B, Sq, Hkv, D)
    for a in range(0, Sq, chunk):
        b = min(a + chunk, Sq)
        kb = b if wedge else Skv  # keys this block can reach
        qg = q[:, a:b].float().reshape(B, b - a, Hkv, G, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf[:, :kb]) \
            * (1.0 / math.sqrt(D))
        sq = seg_q[:, a:b]
        m = (sq[:, :, None] == seg_kv[:, None, :kb]) & (sq[:, :, None] > 0)
        iq = torch.arange(a, b, device=dev) + (Skv - Sq)
        if causal:
            m &= (iq[:, None] >= ik[None, :kb])[None]
        if window is not None:
            m &= ((iq[:, None] - ik[None, :kb]) < window)[None]
        s = torch.where(m[:, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf[:, :kb])
        dead = ~m.any(-1)  # (B, b - a): no visible key
        if wedge:  # the chunks the reference's triangle tasks visit
            n = reach[a // c]
            d_o = (csum[:, n - 1] / (n * c))[:, None]
        else:
            d_o = dead_o[:, a:b]
        o = torch.where(dead[:, :, None, None, None], d_o[:, :, :, None], o)
        out[:, a:b] = o.reshape(B, b - a, Hq, D).to(q.dtype)
    return out


def _wedge_tasks(lo: int, hi: int):
    """The reference's static triangle decomposition of the causal chunk
    grid ``[lo, hi)``: ``(q_lo, q_hi, k_lo, k_hi)`` tasks, the diagonal
    leaves (at most two chunks, masked) and the full rectangles below
    them, in the reference's order."""
    n = hi - lo
    if n <= 2:
        return [(lo, hi, lo, hi)]
    h = n // 2
    return (_wedge_tasks(lo, lo + h) + [(lo + h, hi, lo, lo + h)]
            + _wedge_tasks(lo + h, hi))


def _wedge_reach(nq: int):
    """Key chunks each query chunk visits under the wedge: ``[0, n)``,
    ``n`` the end of its diagonal leaf (one chunk past the causal cut for
    the first chunk of a two-chunk leaf)."""
    reach = [0] * nq
    for qlo, qhi, _, khi in _wedge_tasks(0, nq):
        for qi in range(qlo, qhi):
            reach[qi] = max(reach[qi], khi)
    return reach


def _flash_online(q, k, v, *, causal, window, seg_q, seg_kv, c, block_dtype,
                  wedge):
    """The reference's online-softmax flash attention (chunks of ``c``
    positions, both axes padded with segment 0), with the probability block
    cast to ``block_dtype`` before each PV product: per query chunk, runs
    over key chunks (all of them; with a window the ``ceil(window / c) +
    1`` behind it, indices below 0 clipped and masked; with the wedge each
    triangle task's range as its own run, the runs merged in the
    reference's order), each run carrying f32 ``(o, m, l)``."""
    B, Sq0, Hq, D = q.shape
    Skv0, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    nq, nk = -(-Sq0 // c), -(-Skv0 // c)

    def pad(t, n):
        shape = (t.shape[0], n * c - t.shape[1]) + tuple(t.shape[2:])
        return torch.cat([t, t.new_zeros(shape)], 1)

    qc = pad(q.float(), nq).reshape(B, nq, c, Hkv, G, D)
    kc = pad(k.float(), nk).reshape(B, nk, c, Hkv, D)
    vc = pad(v.float(), nk).reshape(B, nk, c, Hkv, D)
    sq = pad(seg_q, nq).reshape(B, nq, c)
    sk = pad(seg_kv, nk).reshape(B, nk, c)
    off = Skv0 - Sq0  # decode-style alignment: queries at the end
    scale = 1.0 / math.sqrt(D)
    iota = torch.arange(c, device=dev)

    def run(qi, kis):
        o = torch.zeros((B, Hkv, G, c, D), dtype=torch.float32, device=dev)
        m = torch.full((B, Hkv, G, c), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, c), dtype=torch.float32, device=dev)
        for ki in kis:
            kk = min(max(ki, 0), nk - 1)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc[:, qi], kc[:, kk]) \
                * scale
            skb = sk[:, kk] if ki >= 0 else torch.zeros_like(sk[:, kk])
            msk = (sq[:, qi, :, None] == skb[:, None, :]) \
                & (sq[:, qi, :, None] > 0)
            iq = qi * c + iota + off
            ik = kk * c + iota
            if causal:
                msk = msk & (iq[:, None] >= ik[None, :])[None]
            if window is not None:
                msk = msk & ((iq[:, None] - ik[None, :]) < window)[None]
            s = torch.where(msk[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(block_dtype).float(), vc[:, kk])
            m = m_new
        return o, m, l

    if wedge:
        runs = [[] for _ in range(nq)]
        for qlo, qhi, klo, khi in _wedge_tasks(0, nq):
            for qi in range(qlo, qhi):
                runs[qi].append(range(klo, khi))
    elif window is None:
        runs = [[range(nk)] for _ in range(nq)]
    else:
        w = -(-window // c)
        runs = [[range(qi + off // c - w, qi + off // c + 1)]
                for qi in range(nq)]
    outs = []
    for qi in range(nq):
        o, m, l = run(qi, runs[qi][0])
        for kis in runs[qi][1:]:  # online-softmax merge of two key ranges
            o2, m2, l2 = run(qi, kis)
            mm = torch.maximum(m, m2)
            a1, a2 = torch.exp(m - mm), torch.exp(m2 - mm)
            o = o * a1[..., None] + o2 * a2[..., None]
            m, l = mm, l * a1 + l2 * a2
        outs.append(o / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, 1)  # (B, nq, Hkv, G, c, D)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * c, Hq, D)
    return out[:, :Sq0].to(q.dtype)


def _dead_rows(vf: torch.Tensor, Sq: int, chunk: int,
               window: Optional[int]) -> torch.Tensor:
    """What the reference's ``flash_attention`` gives a query that sees no
    key: its online softmax pads both axes to multiples of ``c = min(chunk,
    Sq, Skv)`` (zero values) and, on a row masked everywhere, takes every
    visited key with weight ``exp(-1e30 - (-1e30)) = 1``. So the row gets
    the sum of the values in the key chunks it visits over their padded
    count: all ``nk`` chunks, or with a window the ``w + 1`` chunks of its
    lookback (``w = ceil(window / c)``, indices clipped into range, a clip
    counted each time). vf (B, Skv, Hkv, D) f32 -> (B, Sq, Hkv, D) f32."""
    B, Skv = vf.shape[0], vf.shape[1]
    c = min(chunk, Sq, Skv)
    nk = -(-Skv // c)
    if window is None:
        tot = vf.sum(1, keepdim=True) / (nk * c)
        return tot.expand(B, Sq, *vf.shape[2:])
    pad = torch.zeros((B, nk * c - Skv) + tuple(vf.shape[2:]),
                      dtype=vf.dtype, device=vf.device)
    csum = torch.cat([vf, pad], 1).reshape(B, nk, c, *vf.shape[2:]).sum(2)
    w = -(-window // c)
    qi = torch.arange(Sq, device=vf.device) // c + (Skv - Sq) // c
    tot = sum(csum[:, torch.clamp(qi - w + t, 0, nk - 1)]
              for t in range(w + 1))
    return tot / ((w + 1) * c)


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


def _ring_layout(t: torch.Tensor, ring: int) -> torch.Tensor:
    """A prefill's last ``ring`` positions in canonical ring phase (the
    reference's ``ring_layout``): position ``p`` of the row lands at lane
    position ``p % ring``, the phase of decode's write pointer
    ``cache_index % ring``, so the first decoded token overwrites the
    oldest cached one."""
    if t.shape[1] <= ring:
        return t
    return torch.roll(t[:, -ring:], t.shape[1] % ring, dims=1)


def layer_view(cache: Dict[str, torch.Tensor], name: str,
               layer_idx: Optional[int]) -> torch.Tensor:
    """One layer's view of cache leaf ``name`` (L-stacked, or the layer's
    own when ``layer_idx`` is None)."""
    leaf = cache[name]
    return leaf if layer_idx is None else leaf[layer_idx]


def _seq_to_heads(t: torch.Tensor, mesh) -> torch.Tensor:
    """``(B, W / N, H, ...)`` (this rank's positions, every head) ->
    ``(B, W, H / N, ...)`` (every position, this rank's heads): one
    ``all_to_all`` over ``model``."""
    n = mesh.n("model")
    B, w, H = t.shape[:3]
    src = t.reshape((B, w, n, H // n) + t.shape[3:]).movedim(2, 0)
    got = all_to_all(src.contiguous(), mesh, "model")  # [i]: rank i's block
    return got.movedim(0, 1).reshape((B, n * w, H // n) + t.shape[3:])


def _heads_to_seq(t: torch.Tensor, mesh) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`: ``(B, W, H / N, ...)`` ->
    ``(B, W / N, H, ...)``."""
    n = mesh.n("model")
    B, W, h = t.shape[:3]
    src = t.reshape((B, n, W // n, h) + t.shape[3:]).movedim(1, 0)
    got = all_to_all(src.contiguous(), mesh, "model")
    return got.movedim(0, 2).reshape((B, W // n, n * h) + t.shape[3:])


def _place_lane(t: torch.Tensor, width: int, mesh, seq_cut: bool,
                heads_cut: bool) -> torch.Tensor:
    """A prefill's lane leaf ``(B, S, heads, ...)`` (``heads``: this rank's
    block when ``heads_cut``, else every head) as the cache holds it on a
    mesh (``launch.sharding.cache_specs``): every head, and this rank's
    block of the ``width`` positions when ``seq_cut``."""
    if seq_cut:
        if t.shape[1] < width:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, width - t.shape[1]))
        return _heads_to_seq(t, mesh) if heads_cut else mesh.block(t, 1)
    return mesh.gather(t, 2) if heads_cut else t


def _write_rows(lane: torch.Tensor, t: torch.Tensor, slot: torch.Tensor,
                keep: torch.Tensor) -> None:
    """``lane[b, slot[b]] = t[b]`` in place for the rows in ``keep`` whose
    ``slot`` lies in the lane (the reference's one-hot select); other rows
    write their own value back (one position per row, no host sync)."""
    B, width = lane.shape[0], lane.shape[1]
    keep = keep & (slot >= 0) & (slot < width)
    rows = torch.arange(B, device=lane.device)
    pos = torch.clamp(slot, 0, width - 1)
    old = lane[rows, pos]
    keep_b = keep.reshape((B,) + (1,) * (old.dim() - 1))
    lane[rows, pos] = torch.where(keep_b, t.to(lane.dtype), old)


def _row_cut(p: Dict, width: int) -> bool:
    """A dense row-parallel linear whose input rows ``model`` cuts."""
    return "w" in p and p["w"].shape[-2] != width


# The Megatron side of each linear of the attention block and the FFN
# (``launch/sharding.py``): column-parallel ones give this rank's heads or
# d_ff slice, row-parallel ones take them and give the replicated output.
_PARALLEL = {"wq": "col", "wk": "col", "wv": "col", "wo": "row",
             "w_up": "col", "w_gate": "col", "w_down": "row"}


def _linear_fn(p: Dict, dicts: Optional[Dict], cfg: ModelConfig, mesh=None,
               sparse_train: bool = False):
    """``lin(name, x, family, width)``: linear ``p[name]`` in the compute
    dtype (``sparse_train``: factorized W_D through the straight-through
    projection); on a tensor-parallel ``mesh`` its Megatron half
    (:func:`~repro_torch.core.factorized.parallel_linear`) over the
    ``width`` features that the model axis splits."""
    dt = cfg.compute_dtype
    tp = tensor_parallel_size(mesh) > 1

    def lin(name, x, family, width):
        if not tp:
            return apply_linear(p[name], x, dicts, family, compute_dtype=dt,
                                fcfg=cfg.factorization,
                                sparse_train=sparse_train).to(dt)
        return parallel_linear(p[name], x, dicts, family, mesh=mesh,
                               fcfg=cfg.factorization, kind=_PARALLEL[name],
                               width=width, compute_dtype=dt,
                               sparse_train=sparse_train).to(dt)

    return lin


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
    layer_idx: Optional[int] = 0,     # None: unstacked leaves (one layer)
    cache_index: Optional[torch.Tensor] = None,  # (B,) tokens resident
    pages: Optional[Dict] = None,     # {"bt": (B, n), "width", "page_size"}
    slot_mask: Optional[torch.Tensor] = None,  # (B,) bool writable rows
    n_new: Optional[torch.Tensor] = None,      # (B,): mixed step
    seg_ids: Optional[torch.Tensor] = None,    # (B, S): prefill packing
    prefix_kv: Optional[Dict] = None,  # suffix prefill: {"k"/"v": (B, Np,
    # Hkv, D) post-RoPE shared prefix, "len": (B,) valid prefix length}
    window=...,                       # None, a window, or ...: the config's
    mesh=None,                        # tensor-parallel mesh: this rank's heads
    sparse_train: bool = False,       # W_D through the STE (training)
    kv: Optional[torch.Tensor] = None,      # (B, Skv, d) cross-attention
    seg_kv: Optional[torch.Tensor] = None,  # (B, Skv) memory's segments
    prefix: str = "attn",             # dictionary families {prefix}_q ...
    lanes: Optional[Dict] = None,     # the cache's placement on a mesh
) -> torch.Tensor:
    """GQA attention with RoPE, in the four forms the serving paths take:

    * **prefill** (no ``cache_index``): :func:`flash_attention` over the
      unquantized K/V with segment ids (and the sliding window), then,
      when ``cache`` is given, the K/V (int8 codes and scales with
      ``kv_quant``) written at lane positions ``[0, S)`` of contiguous
      caches ``(L, B, S_max, Hkv, D)``; a ring cache narrower than ``S``
      (``init_cache(..., ring=True)`` of a windowed stack) takes the last
      ``ring`` positions in canonical ring phase.
      With ``prefix_kv`` (a suffix prefill over a shared prefix) the keys
      are [prefix ∥ suffix]: the suffix queries, at absolute
      ``positions``, sit at the end of the key axis and see the whole
      valid prefix (``len``; rotated when it was written, so it takes no
      RoPE here) and their causal suffix; the cache receives the suffix
      only (no window: a ring lane shares a prefix only while the whole
      sequence fits it);
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

    ``window`` is the layer's attention window: ``...`` (the default) takes
    ``cfg.sliding_window``; a heterogeneous stack passes its ``local``
    layers' ``cfg.local_window``. ``layer_idx`` picks the layer of
    L-stacked cache leaves; ``None`` means the leaves are one layer's own
    (a heterogeneous stack's ``{"layer_XX": {...}}`` caches).

    With a window the lanes are rings of ``ring`` positions
    (the cache's width, or ``pages["width"]``): decode writes at
    ``cache_index % ring`` and attends the lane's ``[0, min(cache_index +
    1, ring))`` (canonical ring phase: every resident position is inside
    the window); the mixed step passes the ring and the window to its
    attention.

    On a tensor-parallel ``mesh`` every form runs on this rank's block of
    heads (``Hq / N`` query and ``Hkv / N`` kv heads, the GQA group
    unchanged) against the rank's head slice of the cache, through the
    same kernels; ``wo`` is row-parallel, so the output is replicated.
    Where ``N`` does not divide both head counts, prefill and training
    attention gather q, k and v over ``model`` and every rank of the axis
    attends every head (``wo`` then takes the rank's block of the output);
    decode refuses such a mesh with the reference's message
    (``kernels/tda/sharded.py::check_head_split``).

    ``lanes`` (the mesh steps of ``launch/steps.py``: ``Model.prefill`` /
    ``decode_step`` with ``specs=``) is the placement of this layer's
    contiguous cache leaves, ``launch.sharding.cache_specs`` without the
    L axis: rows over the data-parallel axes (the rank's batch rows), the
    positions over ``model`` where it divides them, every head. A prefill
    moves its K/V there from the rank's heads by one ``all_to_all`` over
    ``model`` a leaf (an ``all_gather`` of the heads when the positions
    are not cut); a decode step gathers the token's K/V over the heads,
    writes it into the rank's block of positions, and moves the lanes
    back to the rank's heads, every position, by one ``all_to_all`` a
    leaf, the move that the reference's compiled program makes at its
    ``shard_map`` boundary (``kernels/tda/sharded.py``), before it
    attends.

    **Cross-attention** (``kv``, the encoder-decoder's memory; no cache):
    keys and values come from ``kv``, no RoPE, no causal mask, so every
    query sees every memory position of its ``seg_kv`` segment (a padded
    source: ``seg_kv`` 0 on its pad). Prefill attention casts its
    probability blocks to ``cfg.flash_block_dtype`` and, without a
    prefix, takes ``cfg.causal_wedge``. The linears go through the
    ``{prefix}_q`` ... ``{prefix}_o`` dictionaries (the paper models'
    ``enc_attn``, ``dec_attn``, ``dec_xattn``).
    """
    B, S, _ = x.shape
    hd = cfg.head_dim
    dt = cfg.compute_dtype
    if kv is not None and (cache is not None or cache_index is not None
                           or prefix_kv is not None):
        raise ValueError("cross-attention (kv=) runs without caches, as the "
                         "reference's encoder-decoder does")
    lin = _linear_fn(p, dicts, cfg, mesh, sparse_train)
    qw, kvw = cfg.n_heads * hd, cfg.kv_heads * hd
    tp = tensor_parallel_size(mesh)
    whole = tp > 1 and bool(cfg.n_heads % tp or cfg.kv_heads % tp)
    x_kv = x if kv is None else kv
    q = lin("wq", x, f"{prefix}_q", qw)
    k = lin("wk", x_kv, f"{prefix}_k", kvw)
    v = lin("wv", x_kv, f"{prefix}_v", kvw)
    if whole:  # heads do not split over model: every rank attends all
        q, k, v = (t if t.shape[-1] == w else gather_from(t, mesh)
                   for t, w in ((q, qw), (k, kvw), (v, kvw)))
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, x_kv.shape[1], -1, hd)
    v = v.reshape(B, x_kv.shape[1], -1, hd)

    def out(o):
        o = o.reshape(B, S, -1)
        if whole and _row_cut(p["wo"], qw):
            o = scatter_to(o, mesh)
        return lin("wo", o, f"{prefix}_o", qw)
    if cfg.rope and kv is None:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    quant = cache is not None and "k_scale" in cache
    if window is ...:
        window = cfg.sliding_window
    impl = resolve_decode_attn(cfg.decode_attn, x.device)
    block_dtype = torch_dtype(cfg.flash_block_dtype)
    if cache_index is None:
        if prefix_kv is None:
            o = flash_attention(q, k, v, causal=cfg.causal and kv is None,
                                window=window, seg_q=seg_ids,
                                seg_kv=seg_ids if kv is None else seg_kv,
                                chunk=cfg.attn_chunk,
                                block_dtype=block_dtype,
                                wedge=cfg.causal_wedge)
        else:
            pk, pv = prefix_kv["k"].to(dt), prefix_kv["v"].to(dt)
            sq = seg_ids if seg_ids is not None else torch.ones(
                (B, S), dtype=torch.int32, device=x.device)
            plen = torch.as_tensor(prefix_kv["len"], device=x.device)
            pseg = (torch.arange(pk.shape[1], device=x.device)[None, :]
                    < plen.reshape(-1, 1)).to(sq.dtype).expand(B, -1)
            o = flash_attention(q, torch.cat([pk, k], 1),
                                torch.cat([pv, v], 1), causal=cfg.causal,
                                seg_q=sq, seg_kv=torch.cat([pseg, sq], 1),
                                chunk=cfg.attn_chunk,
                                block_dtype=block_dtype)
        if cache is not None:
            ring = layer_view(cache, "k", layer_idx).shape[1]
            placed = lanes is not None and tp > 1
            seq_cut = placed and "model" in spec_axes(lanes["k"][1])
            if seq_cut:
                ring *= tp
            for name, t in _kv_leaves(_ring_layout(k, ring),
                                      _ring_layout(v, ring), quant).items():
                if placed:
                    t = _place_lane(t, ring, mesh, seq_cut, not whole)
                lane = layer_view(cache, name, layer_idx)
                lane[:, :t.shape[1]] = t.to(lane.dtype)
        return out(o)

    ci = cache_index.reshape(-1).to(torch.int64).expand(B)
    if n_new is not None:
        if quant:
            raise ValueError("the mixed step takes unquantized lanes "
                             "(EngineConfig refuses mixed with kv_quant)")
        ps = pages["page_size"]
        ringw = pages["width"]
        bt = pages["bt"]
        kpool = layer_view(cache, "k", layer_idx)
        vpool = layer_view(cache, "v", layer_idx)
        P = kpool.shape[0]
        nn = n_new.reshape(-1).to(torch.int64)
        if slot_mask is not None:
            sm = slot_mask.reshape(-1)
            ci = torch.where(sm, ci, 0)
            nn = torch.where(sm, nn, 0)  # inert row: attends, writes nothing
        # A routed (MoE) stack routes every column of the step together,
        # so the columns j >= n_new take expert capacity: the kernel then
        # computes them as the reference does instead of skipping them.
        o = fused_mixed_attention(q, kpool, vpool, k, v, ci, nn,
                                  block_table=bt, ring=ringw, window=window,
                                  use_kernel=impl == "tda",
                                  all_columns=cfg.moe is not None)
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
        return out(o)

    if S != 1:
        raise ValueError("decode takes one token per row")
    if tp > 1:
        check_head_split(cfg.kv_heads, cfg.n_heads, tp)
    new = _kv_leaves(k[:, 0], v[:, 0], quant)
    placed = lanes is not None and tp > 1
    seq_cut = placed and "model" in spec_axes(lanes["k"][1])
    lanes = {name: layer_view(cache, name, layer_idx) for name in new}
    if placed:
        # The cache holds the rank's block of positions, every head: the
        # token's K/V of every head lands in the block that holds its
        # position, then the lanes move to the rank's heads, every position.
        width = lanes["k"].shape[1]
        ring = width * tp if seq_cut else width
        slot = ci if window is None else ci % ring
        if seq_cut:
            slot = slot - mesh.coord("model") * width
        keep = torch.ones_like(slot, dtype=torch.bool) if slot_mask is None \
            else slot_mask.reshape(-1)
        for name, t in new.items():
            _write_rows(lanes[name], mesh.gather(t, 1), slot, keep)
        lanes = {name: _seq_to_heads(t, mesh) if seq_cut
                 else mesh.block(t, 2) for name, t in lanes.items()}
    elif pages is not None:
        ps = pages["page_size"]
        bt = pages["bt"]
        ring = pages["width"]
        P = lanes["k"].shape[0]
        pos = ci if window is None else ci % ring
        page = torch.gather(bt.long(), 1, (pos // ps)[:, None])[:, 0]
        phys = page * ps + pos % ps
        if slot_mask is not None:
            phys = torch.where(slot_mask.reshape(-1), phys, P * ps)
        for name, t in new.items():
            _write_pool(lanes[name], phys, t)
    else:
        # In place at (b, cache_index[b]) — ring lanes: cache_index % ring —
        # for the writable rows; an index past the lane writes nothing, as
        # the reference's one-hot select. Other rows write their own value
        # back (one distinct position per row, and no host sync to find the
        # writable ones).
        ring = lanes["k"].shape[1]
        slot = ci if window is None else ci % ring
        keep = torch.ones_like(slot, dtype=torch.bool) if slot_mask is None \
            else slot_mask.reshape(-1)
        for name, t in new.items():
            _write_rows(lanes[name], t, slot, keep)
    if slot_mask is not None:
        ci = torch.where(slot_mask.reshape(-1), ci, -1)
    hi = ci + 1  # inactive rows: hi == 0, nothing attended
    if window is not None:  # ring: every resident position is in the window
        hi = torch.clamp(hi, max=ring)
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
    return out(o)


def init_ffn(g: torch.Generator, cfg: ModelConfig,
             bank: Optional[DictionaryBank], lead=(),
             prefix: str = "ffn", d_ff: Optional[int] = None) -> Dict:
    """``w_up``/``w_down`` (and ``w_gate`` for the gated ``swiglu`` and
    ``geglu``) of width ``d_ff`` (default ``cfg.d_ff``) with leading dims
    ``lead``, each dense or factorized through its ``{prefix}_*``
    dictionary (arctic's parallel dense FFN: ``densefn``, ``d_ff_dense``)."""
    d, f, fcfg = cfg.d_model, d_ff or cfg.d_ff, cfg.factorization
    kw = dict(dtype=cfg.params_dtype, lead=lead)
    p = {"w_up": init_linear(g, d, f, fcfg, bank, f"{prefix}_up", **kw),
         "w_down": init_linear(g, f, d, fcfg, bank, f"{prefix}_down", **kw)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = init_linear(g, d, f, fcfg, bank, f"{prefix}_gate",
                                  **kw)
    return p


def ffn_block(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
              dicts: Optional[Dict] = None, prefix: str = "ffn",
              d_ff: Optional[int] = None, mesh=None,
              sparse_train: bool = False) -> torch.Tensor:
    """``w_down(h)`` with ``h = silu(w_gate x) * w_up x`` (``swiglu``),
    ``gelu(w_gate x) * w_up x`` (``geglu``) or ``gelu(w_up x)`` (``gelu``);
    the GELU is the tanh approximation, ``jax.nn.gelu``'s default.
    Factorized weights go through the ``{prefix}_*`` dictionaries. On a
    tensor-parallel ``mesh`` each rank computes its slice of the width
    ``d_ff`` (default ``cfg.d_ff``) and ``w_down`` gives the replicated
    output. ``sparse_train``: factorized W_D through the STE."""
    if cfg.act not in ("swiglu", "geglu", "gelu"):
        raise ValueError(f"unknown FFN activation {cfg.act!r}")
    lin = _linear_fn(p, dicts, cfg, mesh, sparse_train)
    f = d_ff or cfg.d_ff
    up = lin("w_up", x, f"{prefix}_up", f)
    if cfg.act == "swiglu":
        h = F.silu(lin("w_gate", x, f"{prefix}_gate", f)) * up
    elif cfg.act == "geglu":
        h = F.gelu(lin("w_gate", x, f"{prefix}_gate", f),
                   approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return lin("w_down", h, f"{prefix}_down", f)


def init_embedding(g: torch.Generator, cfg: ModelConfig) -> Dict:
    """The token table ``N(0, 0.02^2)`` ``(V, d)`` (none for a model fed
    external embeddings: llava, musicgen, vit) and, with ``learned_pos``,
    the position table ``N(0, 0.02^2)`` ``(max_len, d)``, as the
    reference's ``init_embedding``."""
    p = {}
    if not cfg.external_embeddings:
        p["tok"] = torch.empty((cfg.vocab_size, cfg.d_model),
                               dtype=cfg.params_dtype,
                               device=g.device).normal_(0.0, 0.02, generator=g)
    if cfg.learned_pos:
        p["pos"] = torch.empty((cfg.max_len, cfg.d_model),
                               dtype=cfg.params_dtype,
                               device=g.device).normal_(0.0, 0.02, generator=g)
    return p


def init_lm_head(g: torch.Generator, cfg: ModelConfig) -> Dict:
    """``w ~ N(0, 1/d)`` of shape ``(d, V)``, ``(n_codebooks, d, V)`` for a
    multi-codebook head (musicgen); nothing when tied."""
    if cfg.tie_embeddings:
        return {}
    shape = (cfg.d_model, cfg.vocab_size)
    if cfg.n_codebooks > 1:
        shape = (cfg.n_codebooks,) + shape
    return {"w": torch.empty(shape, dtype=cfg.params_dtype,
                             device=g.device).normal_(
        0.0, 1.0 / math.sqrt(cfg.d_model), generator=g)}


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: an id in ``[-V, 0)`` counts from
    the end, and an id outside ``[-V, V)`` gets a row of NaN (no host sync,
    no device-side assert)."""
    V = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + V, ids)
    bad = (ids < 0) | (ids >= V)
    x = table[torch.clamp(ids, 0, V - 1)]
    return torch.where(bad[..., None], float("nan"), x)


def embed_tokens(p: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                 mesh=None, positions: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The token table's rows of ``tokens`` in the compute dtype, as
    ``jnp.take`` gives them (:func:`take_rows`), so a corrupt batch shows
    as a NaN loss; with ``learned_pos`` and ``positions`` given, plus the
    position table's rows of ``positions`` (the same rule), as the
    reference adds them. A table cut over the vocabulary (a
    tensor-parallel ``mesh``) looks up the tokens of its own block, zeros
    for the others, and one ``all_reduce(SUM)`` (Megatron's ``g`` under
    autograd) assembles the rows (exact), with :func:`take_rows`' rule for
    ids out of range."""
    tok = p["tok"]
    if tensor_parallel_size(mesh) == 1 or tok.shape[0] == cfg.vocab_size:
        x = take_rows(tok, tokens).to(cfg.compute_dtype)
    else:
        V, vl = cfg.vocab_size, tok.shape[0]
        ids = tokens.long()
        ids = torch.where(ids < 0, ids + V, ids)
        loc = ids - mesh.coords["model"] * vl
        hit = (loc >= 0) & (loc < vl)
        x = torch.where(hit[..., None], tok[torch.clamp(loc, 0, vl - 1)],
                        0.0)
        x = reduce_from(x.to(cfg.compute_dtype), mesh)
        bad = (ids < 0) | (ids >= V)
        x = torch.where(bad[..., None], float("nan"), x)
    if cfg.learned_pos and positions is not None:
        x = x + take_rows(p["pos"], positions).to(cfg.compute_dtype)
    return x


def lm_logits(p_head: Dict, p_embed: Dict, x: torch.Tensor,
              cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """f32 logits ``x @ w`` (tied: ``x @ tok.T``); a multi-codebook head
    ``(C, d, V)`` gives ``(B, S, C, V)``. A head cut over the vocabulary
    (a tensor-parallel ``mesh``) computes its block of every row of ``x``,
    and one ``all_gather`` assembles the blocks: every rank ends with the
    same bits."""
    y = _head(p_head, p_embed, x, cfg)
    if tensor_parallel_size(mesh) > 1 and y.shape[-1] != cfg.vocab_size:
        y = mesh.gather(y)
    return y


def _head(p_head: Dict, p_embed: Dict, x: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """f32 logits of the head this rank holds (a vocabulary block of a
    head cut over ``model``)."""
    xf = x.float()
    if cfg.tie_embeddings:
        return xf @ p_embed["tok"].float().T
    if cfg.n_codebooks > 1:
        return torch.einsum("bsd,cdv->bscv", xf, p_head["w"].float())
    return xf @ p_head["w"].float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL over weighted positions: logits (..., V) f32,
    labels (...); with ``weights`` the weighted sum over ``max(sum w,
    1)``."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if weights is None:
        return nll.mean()
    return (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def _chunk_nll(p_head: Dict, p_embed: Dict, h: torch.Tensor,
               labels: torch.Tensor, w: torch.Tensor,
               cfg: ModelConfig, mesh=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's weighted NLL sum and weight sum (multi-codebook: the
    NLL averaged over codebooks first). A head cut over the vocabulary
    (a tensor-parallel ``mesh``) gives this rank's block of the logits
    only: the logsumexp takes the max over ``model`` (all-reduce MAX) and
    the sum of the shifted exponentials over it (``g``), the gold logit
    comes from the rank whose block holds the label (``g`` of the
    others' zeros), and ``h`` enters through ``f``: no ``(B, S, V)``
    logits on any rank."""
    if tensor_parallel_size(mesh) == 1:
        logits = _head(p_head, p_embed, h, cfg)
    else:
        logits = _head(p_head, p_embed, copy_to(h, mesh), cfg)
    if logits.shape[-1] == cfg.vocab_size:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        vl = logits.shape[-1]
        mx = mesh.all_reduce(logits.detach().amax(-1), "model", "max")
        se = torch.exp(logits - mx[..., None]).sum(-1)
        lse = torch.log(reduce_from(se, mesh)) + mx
        loc = labels.long() - mesh.coords["model"] * vl
        hit = (loc >= 0) & (loc < vl)
        g = torch.gather(logits, -1, torch.clamp(loc, 0, vl - 1)[..., None])
        gold = reduce_from(torch.where(hit, g[..., 0], 0.0), mesh)
    nll = lse - gold
    if nll.dim() > w.dim():
        nll = nll.mean(-1)
    return (nll * w).sum(), w.sum()


def chunked_xent(p_head: Dict, p_embed: Dict, h: torch.Tensor,
                 labels: torch.Tensor, cfg: ModelConfig,
                 weights: Optional[torch.Tensor] = None,
                 chunk: int = 512, mesh=None) -> torch.Tensor:
    """Cross-entropy of the LM head over ``h`` (B, S, d) without holding
    every position's (B, S, V) logits: a loop over sequence chunks of
    ``c = min(chunk, S)`` positions, each computing its logits, logsumexp
    and gold logit. Each chunk runs under ``torch.utils.checkpoint``, so
    its logits are recomputed in the backward pass instead of saved (the
    reference's ``jax.checkpoint(nothing_saveable)`` over its scan). When
    ``c`` does not divide ``S``: :func:`cross_entropy` over the full
    logits, as in the reference. Labels ``(B, S)``, or ``(B, S, C)`` for a
    multi-codebook head.

    On a ``mesh`` (one rank of the train step: ``h`` its batch block) a
    head cut over ``model`` takes the vocabulary-parallel path of
    :func:`_chunk_nll` (one chunk of all ``S`` when ``c`` does not divide
    it), and the loss is the global one, ``Σ nll / Σ weights`` over the
    whole batch: the weight sum is all-reduced over ``pod`` / ``data``
    and the NLL sum goes through ``g`` over them, so every rank holds the
    same loss and its backward gives its own block's share of the
    gradient."""
    B, S, _ = h.shape
    c = min(chunk, S)
    if S % c != 0:
        if mesh is None:
            return cross_entropy(lm_logits(p_head, p_embed, h, cfg), labels,
                                 weights)
        c = S
    if weights is None:
        weights = torch.ones((B, S), dtype=torch.float32, device=h.device)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    w_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for a in range(0, S, c):
        n_i, w_i = checkpoint(_chunk_nll, p_head, p_embed, h[:, a:a + c],
                              labels[:, a:a + c], weights[:, a:a + c], cfg,
                              mesh, use_reentrant=False)
        nll_sum = nll_sum + n_i
        w_sum = w_sum + w_i
    if mesh is not None:
        w_sum = w_sum.detach()
        for ax in dp_axes(mesh):
            w_sum = mesh.all_reduce(w_sum, ax)
            nll_sum = reduce_from(nll_sum, mesh, ax)
    return nll_sum / torch.clamp(w_sum, min=1.0)
