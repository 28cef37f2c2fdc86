"""Mixture-of-Experts FFN (``repro.models.moe``'s local oracle): GShard-style
capacity dispatch, as used by dbrx-132b (16 experts, top-4) and arctic-480b
(128 experts, top-2, plus arctic's parallel dense FFN in the model).

``moe_ffn`` routes every token of the call's ``(B, S)`` batch together:
``T = B * S`` tokens, each expert takes at most ``C = ceil(T * k / E *
capacity_factor)`` of them, and claims past ``C`` are dropped (they add
nothing). So which tokens the caller feeds in — the engine's idle slots,
the columns ``j >= n_new`` of a mixed step, a prefill sweep's pad rows —
decides which live tokens keep their experts; the port feeds the same
tokens as the reference and computes them the same way.

The expert products are batched matmuls (``torch.bmm``), as the reference's
are plain ``einsum``s outside any Pallas kernel. Three weight formats, by
leaf: dense ``w`` ``(E, d_in, d_out)``; factorized ``wd`` ``(E, r, d_out)``
through the family dictionary (``moe_gate``, ``moe_up``, ``moe_down``),
shared across layers and experts; and compressed streams, decompressed once
per call (the dictionary with ``decompress_ws_entry``, each expert's W_D
with ``decompress_wd_leaf``) before two batched products. No expert goes
through the DMM or SMM kernels, as none does in the reference.

On a mesh (``moe_ffn(..., mesh=)``) the function is the reference's
``_moe_sharded_body`` on one rank: experts cut over the ``data`` axis
(expert parallelism) and their contraction over ``model`` (a dense
expert's ``d_ff`` slice, a factorized one's rank), exchanged by a tiled
``all_to_all`` over ``data`` (none on a ``(1, N)`` mesh), with the
rank's tokens routed and their capacity counted per source shard.

``ROUTER_COUNTS`` keeps, per device, the claims routed and the claims
dropped by every call since ``reset_router_counts`` (on the device, no
host sync; ``router_counts()`` reads them).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import sparsity
from repro_torch.core.errors import UnsupportedConfigError
from repro_torch.core.factorized import (DictionaryBank, FactorizationConfig,
                                        decompress_wd_leaf,
                                        decompress_ws_entry, init_linear,
                                        parallel_linear)
from repro_torch.launch.mesh import all_to_all, reduce_from
from repro_torch.launch.sharding import dp_axes
from repro_torch.models.common import ModelConfig

__all__ = ["init_moe", "moe_ffn", "router_counts", "reset_router_counts",
           "ROUTER_COUNTS"]

_STREAMS = ("wd_first", "wd_deltas", "wd_vq", "wd_scale", "wd_offset",
            "wd_bits")
# device -> int64 (2,) tensor: [claims routed, claims dropped]
ROUTER_COUNTS: Dict[torch.device, torch.Tensor] = {}


def reset_router_counts() -> None:
    ROUTER_COUNTS.clear()


def router_counts() -> Dict[str, int]:
    """Claims routed and dropped since the last reset, over every device
    (a host sync per device)."""
    tot = [0, 0]
    for c in ROUTER_COUNTS.values():
        a, b = c.tolist()
        tot[0] += a
        tot[1] += b
    return {"claims": tot[0], "dropped": tot[1]}


def _count(keep: torch.Tensor) -> None:
    dev = keep.device
    c = ROUTER_COUNTS.get(dev)
    if c is None:
        c = ROUTER_COUNTS[dev] = torch.zeros(2, dtype=torch.int64,
                                             device=dev)
    c[0] += keep.numel()
    c[1] += (~keep).sum()


def init_moe(g: torch.Generator, cfg: ModelConfig,
             bank: Optional[DictionaryBank], lead=()) -> Dict:
    """The router ``N(0, 0.02^2)`` ``(d, E)`` and each expert matrix,
    stacked ``(E, ...)`` behind leading dims ``lead``: factorized ``wd ~
    N(0, 1/r)`` through the shared ``moe_*`` dictionary where the
    factorization applies, else dense ``w ~ N(0, 1/d_in)``; in the params
    dtype, drawn from ``g`` (the reference's ``init_moe``)."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    lead = tuple(lead)
    dt = cfg.params_dtype
    router = torch.empty(lead + (d, E), dtype=dt, device=g.device).normal_(
        0.0, 0.02, generator=g)
    kw = dict(dtype=dt, lead=lead + (E,))
    fcfg = cfg.factorization
    return {"router": router,
            "w_gate": init_linear(g, d, f, fcfg, bank, "moe_gate", **kw),
            "w_up": init_linear(g, d, f, fcfg, bank, "moe_up", **kw),
            "w_down": init_linear(g, f, d, fcfg, bank, "moe_down", **kw)}


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest in descending order, the lower index
    first among equal values (a stable descending sort keeps it)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _router(tokens: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """f32 softmax over the router logits, top-k, gates renormalized by
    ``max(sum, 1e-9)``; the Switch load-balance aux loss ``E * sum_e f_e
    p_e``. Returns ``(gates (T, k) f32, eidx (T, k) int64, aux)``."""
    logits = tokens.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = _top_k(probs, top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = router_w.shape[1]
    me = probs.mean(0)
    # counts by one-hot sums (exact; bincount would sync with the host)
    ce = F.one_hot(eidx.reshape(-1), E).sum(0).float() / eidx.numel()
    aux = E * torch.sum(me * ce)
    return gates, eidx, aux


def _dispatch(tokens: torch.Tensor, eidx: torch.Tensor, E: int, C: int):
    """Scatter tokens into an ``(E, C, d)`` buffer in the tokens' dtype.
    Claims go slot by slot (``j = 0..k-1``); a claim's position is its
    expert's running count plus its exclusive rank among slot ``j``'s
    claims in token order; positions past ``C`` are dropped (``keep``
    false, ``pos`` 0, nothing added). Returns ``(buf, pos, keep)``, the
    last two ``(T, k)``."""
    T, d = tokens.shape
    k = eidx.shape[1]
    buf = tokens.new_zeros((E * C, d))
    counts = torch.zeros(E, dtype=torch.int64, device=tokens.device)
    pos_all, keep_all = [], []
    for j in range(k):
        e = eidx[:, j]
        oh = F.one_hot(e, E)  # (T, E) int64
        rank = torch.cumsum(oh, 0) - oh
        pos = counts[e] + rank.gather(1, e[:, None])[:, 0]
        keep = pos < C
        pos_c = torch.where(keep, pos, 0)
        contrib = torch.where(keep[:, None], tokens, 0)
        buf.index_add_(0, e * C + pos_c, contrib)
        counts = counts + oh.sum(0)
        pos_all.append(pos_c)
        keep_all.append(keep)
    return buf.view(E, C, d), torch.stack(pos_all, 1), \
        torch.stack(keep_all, 1)


def _combine(buf_out: torch.Tensor, gates: torch.Tensor, eidx: torch.Tensor,
             pos: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each token's kept claims, gate-weighted, summed in f32 in slot
    order: ``(T, d)`` f32."""
    T, k = eidx.shape
    out = torch.zeros((T, buf_out.shape[-1]), dtype=torch.float32,
                      device=buf_out.device)
    for j in range(k):
        g = buf_out[eidx[:, j], pos[:, j]]
        out += torch.where(keep[:, j, None], g.float(), 0.0) \
            * gates[:, j, None]
    return out


def _expert_mat(pp: Dict, x: torch.Tensor, dicts: Optional[Dict],
                family: str, dt: torch.dtype,
                ste: Optional[FactorizationConfig] = None) -> torch.Tensor:
    """``x (E, C, d_in)`` through every expert's matrix: ``(E, C, d_out)``.
    ``ste`` (sparse training): a factorized ``wd`` (E, r, d_out) through
    the straight-through projection as the reference applies it, over the
    ``E * r`` rows of all experts together with ``nnz_for(r)`` kept per
    column."""
    if "w" in pp:
        return torch.bmm(x, pp["w"].to(dt))
    if "wd_vq" in pp:
        ws = decompress_ws_entry(dicts[family], x.shape[-1], dt)  # (d, r)
        y1 = x @ ws
        wd = torch.stack([decompress_wd_leaf(
            {s: pp[s][e] for s in _STREAMS if s in pp}, ws.shape[1], dt)
            for e in range(x.shape[0])])  # (E, r, d_out)
        return torch.bmm(y1, wd)
    wd = pp["wd"]
    if ste is not None and ste.ste_in_forward:
        nnz = max(1, ste.nnz_for(wd.shape[1]))
        wd = sparsity.ste_sparse(wd.reshape(-1, wd.shape[-1]),
                                 nnz).reshape(wd.shape)
    y1 = x @ dicts[family].to(dt)
    return torch.bmm(y1, wd.to(dt))


def _expert_ffn(buf: torch.Tensor, p: Dict, dicts: Optional[Dict],
                dt: torch.dtype,
                ste: Optional[FactorizationConfig] = None) -> torch.Tensor:
    """SwiGLU experts on the dispatch buffer: ``(E, C, d) -> (E, C, d)``."""
    up = _expert_mat(p["w_up"], buf, dicts, "moe_up", dt, ste)
    gate = _expert_mat(p["w_gate"], buf, dicts, "moe_gate", dt, ste)
    h = (F.silu(gate.float()) * up.float()).to(dt)
    return _expert_mat(p["w_down"], h, dicts, "moe_down", dt, ste)


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    return max(1, int(math.ceil(T * k / E * cf)))


def moe_ffn(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
            dicts: Optional[Dict] = None, mesh=None,
            sparse_train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed-expert FFN over ``x (B, S, d)``: ``(y (B, S, d) in the
    compute dtype, aux)`` — the reference's ``moe_ffn(mesh=None)``
    (``sparse_train``: factorized experts through the STE). On a mesh of
    more than one rank, :func:`_moe_sharded` on this rank's shards: ``p``
    as ``launch.sharding.shard_params`` cut it (experts over ``data``:
    expert parallelism, never gathered; their contraction over ``model``)
    and ``x`` this rank's batch block over ``pod`` / ``data``
    (replicated over ``model``). It trains too: its exchanges and
    reductions are the autograd-aware collectives of ``launch/mesh.py``.
    As in the reference, the experts' straight-through projection does
    not run on a mesh (the train loop's post-update projection of W_D
    stands in for it)."""
    if mesh is not None and mesh.size > 1:
        if any("wd_vq" in p[n] for n in ("w_gate", "w_up", "w_down")):
            raise UnsupportedConfigError(
                "compressed expert weights (wd_vq streams) are local-only "
                "for now: the EP/TP placement shards the dense 'wd' leaf, "
                "not the streaming format. Either serve compressed MoE "
                "without a mesh (mesh=None / a 1-device mesh), or serve "
                "dense-factorized params (skip Model.compress_params) on "
                "the mesh.")
        return _moe_sharded(p, x, cfg, dicts, mesh)
    B, S, d = x.shape
    m = cfg.moe
    dt = cfg.compute_dtype
    tokens = x.reshape(B * S, d)
    gates, eidx, aux = _router(tokens, p["router"], m.top_k)
    C = _capacity(B * S, m.top_k, m.n_experts, m.capacity_factor)
    buf, pos, keep = _dispatch(tokens, eidx, m.n_experts, C)
    _count(keep)
    buf_out = _expert_ffn(buf, p, dicts, dt,
                          cfg.factorization if sparse_train else None)
    y = _combine(buf_out, gates, eidx, pos, keep).reshape(B, S, d).to(dt)
    return y, aux


def _moe_sharded(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 dicts: Optional[Dict], mesh) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The reference's ``_moe_sharded_body`` on this rank: route the
    rank's tokens, dispatch them into ``(E, C, d)`` with the capacity of
    its own token count, send expert block ``j`` to rank ``j`` of the
    ``data`` axis (``E / D`` experts each), run the received tokens
    through the local experts (the ``d_ff`` slice or rank block of
    ``model``, one ``all_reduce`` per contraction over it), send them back
    and combine. ``aux`` is averaged over ``pod`` / ``data``. Sparse
    training sends no expert through the STE here: the reference's body
    runs its experts with the ``model`` axis named, which turns the STE
    off whether or not that axis cuts ``r``."""
    B, S, d = x.shape
    m = cfg.moe
    dt = cfg.compute_dtype
    n_ep = mesh.n("data")
    E = m.n_experts
    E_loc = E // n_ep
    tokens = x.reshape(B * S, d)
    gates, eidx, aux = _router(tokens, p["router"], m.top_k)
    C = _capacity(B * S, m.top_k, E, m.capacity_factor)
    buf, pos, keep = _dispatch(tokens, eidx, E, C)
    _count(keep)
    recv = all_to_all(buf, mesh, "data")  # (n_ep * E_loc, C, d) by source
    recv = recv.reshape(n_ep, E_loc, C, d).transpose(0, 1).reshape(
        E_loc, n_ep * C, d)
    kw = dict(mesh=mesh, fcfg=cfg.factorization, width=m.d_ff_expert,
              compute_dtype=dt)
    up = parallel_linear(p["w_up"], recv, dicts, "moe_up", kind="col", **kw)
    gate = parallel_linear(p["w_gate"], recv, dicts, "moe_gate", kind="col",
                           **kw)
    h = (F.silu(gate.float()) * up.float()).to(dt)
    out = parallel_linear(p["w_down"], h, dicts, "moe_down", kind="row",
                          **kw).to(dt)
    back = out.reshape(E_loc, n_ep, C, d).transpose(0, 1).reshape(
        n_ep * E_loc, C, d)
    y = _combine(all_to_all(back, mesh, "data"), gates, eidx, pos, keep)
    aux, n_dp = aux.reshape(1), 1
    for a in dp_axes(mesh):
        aux = reduce_from(aux, mesh, a)
        n_dp *= mesh.n(a)
    return y.reshape(B, S, d).to(dt), aux[0] / n_dp
