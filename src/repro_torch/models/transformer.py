"""The composable model (``repro.models.transformer``): embeds -> block
stack -> norm -> logits, for uniform attention stacks (RMSNorm or
LayerNorm; full or sliding-window attention), whose FFN is dense (SwiGLU,
GeGLU or GELU) or routed: the MoE family (dbrx-132b, arctic-480b), with
arctic's parallel dense FFN (``models/moe.py``).

The reference's ``lax.scan`` over layers is a Python loop here. Parameters
are nested dicts of tensors in the reference's layout (uniform stacks carry
a leading L axis on ``params["layers"]``; factorized models add the shared
``params["dicts"]``), so ``models/bridge.py`` can hand over a reference
``Model.init`` or ``compress_params`` tree unchanged. ``Model.init`` draws its
own weights from a ``torch.Generator``; they cannot match the reference's
numbers, so every parity test uses bridged parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.errors import UnsupportedConfigError
from repro_torch.core.factorized import DictionaryBank, compress_model_params
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import init_moe, moe_ffn

__all__ = ["Model", "check_supported"]


def check_supported(cfg: ModelConfig) -> None:
    """Refuse what this slice of the port does not serve, naming the slice
    (ROADMAP Queue 1) that brings it."""
    if cfg.family in ("ssm", "hybrid") or cfg.layer_pattern is not None \
            or cfg.ssm is not None:
        raise UnsupportedConfigError(
            f"{cfg.name}: recurrent stacks (the {cfg.family!r} family) "
            "come with a later slice (ROADMAP Queue 1 item 10c)")
    if cfg.family not in ("dense", "moe") \
            or (cfg.family == "moe") != (cfg.moe is not None):
        raise UnsupportedConfigError(
            f"{cfg.name}: the {cfg.family!r} family (external embeddings, "
            "multi-codebook logits) comes with a later slice (ROADMAP "
            "Queue 1 item 10b)")
    if cfg.external_embeddings or cfg.n_codebooks != 1:
        raise UnsupportedConfigError(
            f"{cfg.name}: external embeddings / multi-codebook logits come "
            "with a later slice (ROADMAP Queue 1 item 10b)")
    if cfg.learned_pos:
        raise UnsupportedConfigError(
            f"{cfg.name}: learned positions come with the paper models "
            "(ROADMAP Queue 1 item 12)")
    if cfg.act not in ("swiglu", "geglu", "gelu") \
            or cfg.norm not in ("rmsnorm", "layernorm"):
        raise UnsupportedConfigError(
            f"{cfg.name}: unknown block (act={cfg.act!r}, "
            f"norm={cfg.norm!r})")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


_CAST_KEYS = ("w", "wd", "b")  # linear leaves used in the compute dtype


class Model:
    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.weight_format not in ("dense", "compressed"):
            raise ValueError(
                f"weight_format must be 'dense' or 'compressed', "
                f"got {cfg.weight_format!r}")
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def with_weight_format(self, fmt: str) -> "Model":
        """Same model, another weight representation (``dense`` /
        ``compressed``). The forward pass dispatches per leaf, so this is
        metadata the engine reports in ``decode_stats``."""
        if fmt == self.cfg.weight_format:
            return self
        return Model(dataclasses.replace(self.cfg, weight_format=fmt),
                     self.device)

    def compress_params(self, params: Dict, value_bits: int = 6):
        """Factorized params -> the T-REX streaming format, on the params'
        device. Returns ``(model, cparams, stats)``: a
        ``weight_format="compressed"`` model, the compressed tree and the
        stream-bits accounting of
        :func:`repro_torch.core.factorized.compress_model_params` (feed
        ``stats["weight_stream_bits"]`` to the engine's
        ``weight_stream_bits``)."""
        cparams, stats = compress_model_params(
            params, self.cfg.factorization, value_bits=value_bits)
        return self.with_weight_format("compressed"), cparams, stats

    def with_decode_attn(self, mode: str,
                         block_k: Optional[int] = None) -> "Model":
        """Same model, another decode-attention impl (``dense``/``tda``/
        ``auto``) and optional predication-block size."""
        block_k = block_k or self.cfg.decode_block_k
        if mode == self.cfg.decode_attn and block_k == self.cfg.decode_block_k:
            return self
        return Model(dataclasses.replace(self.cfg, decode_attn=mode,
                                         decode_block_k=block_k),
                     self.device)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    def init(self, seed: int = 0) -> Dict:
        """Random parameters in the reference's layout and distributions
        (``w ~ N(0, 1/d_in)``; factorized: dictionaries ``N(0, 1/d_in)``
        under ``params["dicts"]`` and per-layer ``wd ~ N(0, 1/r)``; zero
        biases, unit norm scales (LayerNorm: zero norm biases), embeddings
        ``N(0, 0.02^2)``, head ``N(0, 1/d)``), drawn on ``self.device`` from
        a ``torch.Generator`` seeded with ``seed``."""
        cfg = self.cfg
        g = torch.Generator(device=self.device).manual_seed(seed)
        dt, dev, Ln, d = cfg.params_dtype, self.device, cfg.n_layers, \
            cfg.d_model
        bank = DictionaryBank(cfg.factorization, dt) \
            if cfg.factorization.enabled else None

        def normal(shape, std):
            return torch.empty(shape, dtype=dt, device=dev).normal_(
                0.0, std, generator=g)

        layers = {
            "norm1": L.init_norm(cfg, (Ln,), dev),
            "attn": L.init_attention(g, cfg, bank, lead=(Ln,)),
            "norm2": L.init_norm(cfg, (Ln,), dev),
        }
        if cfg.moe is None:
            layers["ffn"] = L.init_ffn(g, cfg, bank, lead=(Ln,))
        else:
            layers["moe"] = init_moe(g, cfg, bank, lead=(Ln,))
            if cfg.moe.dense_residual:
                layers["dense_ffn"] = L.init_ffn(
                    g, cfg, bank, lead=(Ln,), prefix="densefn",
                    d_ff=cfg.moe.d_ff_dense)
        params: Dict[str, Any] = {
            "embed": {"tok": normal((cfg.vocab_size, d), 0.02)},
            "layers": layers,
            "final_norm": L.init_norm(cfg, (), dev),
            "lm_head": {} if cfg.tie_embeddings
            else {"w": normal((d, cfg.vocab_size), 1.0 / math.sqrt(d))},
        }
        if bank is not None:
            params["dicts"] = bank.dicts
        return params

    def prepare(self, params: Dict) -> Dict:
        """Serving copy of ``params``: the layers' dense ``w``, factorized
        ``wd`` and biases, the raw dictionaries and the token embedding in
        the compute dtype, made once here instead of on every step.
        Compressed streams, nibble-packed codes and LUTs stay as they are.
        At float32 this changes nothing. At bf16 compute over f32 params
        the port then multiplies in bf16, where the reference's dense and
        factorized ``apply_linear`` multiplies the bf16 activation by the
        f32 weight as an f32 product (and casts the result to bf16): those
        outputs differ from the reference's by that rounding (the MoE
        experts' ``einsum`` casts its weights to the compute dtype, as
        here). Norm scales, the MoE router and the LM head stay as they
        are: the reference computes norms, routing and logits in f32."""
        dt = self.cfg.compute_dtype

        def cast(node):
            return {k: (cast(v) if isinstance(v, dict)
                        else v.to(dt) if k in _CAST_KEYS else v)
                    for k, v in node.items()}

        out = dict(params)
        out["layers"] = {k: v if k.startswith("norm") else cast(v)
                         for k, v in params["layers"].items()}
        if "dicts" in params:
            out["dicts"] = {f: (e if isinstance(e, dict) else e.to(dt))
                            for f, e in params["dicts"].items()}
        if not self.cfg.tie_embeddings:
            out["embed"] = {"tok": params["embed"]["tok"].to(dt)}
        return out

    # ------------------------------------------------------------------
    # caches / steps
    # ------------------------------------------------------------------

    def _block_ring(self, kind: str, max_len: int, ring: bool = True) -> int:
        """Sequence capacity of one attention lane: the window (the
        ``local`` kind's ``local_window``, else ``sliding_window``) clamps
        it to a ring of ``min(window, max_len)`` positions unless
        ``ring=False`` (full-length caches: the engine's prefill, whose
        lane gather must address every row position)."""
        cfg = self.cfg
        window = cfg.local_window if kind == "local" else cfg.sliding_window
        if window is None or not ring:
            return max_len
        return min(window, max_len)

    def init_cache(self, batch: int, max_len: int,
                   ring: bool = True) -> Dict[str, torch.Tensor]:
        """Zero contiguous caches ``(L, batch, width, Hkv, D)`` in the
        compute dtype, or, with ``kv_quant``, int8 codes plus f32
        ``k_scale``/``v_scale`` ``(L, batch, width, Hkv)``; ``width`` is
        :meth:`_block_ring` of ``max_len`` (the ring of a windowed stack
        with ``ring=True``). (The page pools of the slot table are
        ``init_cache(num_pages, page_size, ring=False)``.)"""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, self._block_ring("attn", max_len, ring),
                 cfg.kv_heads, cfg.head_dim)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        if cfg.kv_quant:
            return {"k": zeros(shape, torch.int8),
                    "v": zeros(shape, torch.int8),
                    "k_scale": zeros(shape[:-1], torch.float32),
                    "v_scale": zeros(shape[:-1], torch.float32)}
        return {"k": zeros(shape, cfg.compute_dtype),
                "v": zeros(shape, cfg.compute_dtype)}

    def cache_lane_specs(self) -> Dict[str, str]:
        """Per-leaf lane kinds of :meth:`init_cache`: every leaf is a
        per-token ``"kv"`` lane (full, or a ring of the window)."""
        return {name: "kv" for name in (
            ("k", "v", "k_scale", "v_scale") if self.cfg.kv_quant
            else ("k", "v"))}

    def _stack(self, params, x, *, positions, caches, cache_index=None,
               slot_mask=None, pages=None, n_new=None, seg_ids=None,
               prefix_kv=None):
        cfg = self.cfg
        lay = params["layers"]
        dicts = params.get("dicts")
        for i in range(cfg.n_layers):
            lp = _tree_map(lambda t: t[i], lay)
            h = L.apply_norm(lp["norm1"], x)
            pre = None if prefix_kv is None else {
                "k": prefix_kv["k"][i], "v": prefix_kv["v"][i],
                "len": prefix_kv["len"]}
            x = x + L.attention_block(
                lp["attn"], h, cfg=cfg, dicts=dicts, positions=positions,
                cache=caches, layer_idx=i, cache_index=cache_index,
                pages=pages, slot_mask=slot_mask, n_new=n_new,
                seg_ids=seg_ids, prefix_kv=pre)
            h2 = L.apply_norm(lp["norm2"], x)
            if cfg.moe is None:
                x = x + L.ffn_block(lp["ffn"], h2, cfg=cfg, dicts=dicts)
            else:
                # The reference's order: the routed experts, then arctic's
                # parallel dense FFN on the same normed input. The aux
                # loss belongs to training.
                x = x + moe_ffn(lp["moe"], h2, cfg=cfg, dicts=dicts)[0]
                if cfg.moe.dense_residual:
                    x = x + L.ffn_block(lp["dense_ffn"], h2, cfg=cfg,
                                        dicts=dicts, prefix="densefn")
        return L.apply_norm(params["final_norm"], x)

    def logits(self, params: Dict, h: torch.Tensor) -> torch.Tensor:
        return L.lm_logits(params["lm_head"], params["embed"], h, self.cfg)

    def hidden(self, params: Dict, batch: Dict, *,
               caches: Optional[Dict] = None,
               prefix_kv: Optional[Dict] = None) -> Tuple[torch.Tensor, Any]:
        """Full-sequence forward up to the final norm: ``(h (B, S, d),
        caches)``. batch ``{"inputs": (B, S)}`` with optional
        ``"positions"`` (default ``0..S-1``) and ``"seg_ids"`` (packed
        rows; 0 is padding). With ``caches`` (contiguous, :meth:`init_cache`
        with at least S positions) every layer writes its K/V at positions
        ``[0, S)``, in place. ``prefix_kv`` (suffix prefill): the post-RoPE
        K/V of a shared prompt prefix, ``{"k", "v": (L, B, Np, Hkv, D),
        "len": (B,)}``, which every layer prepends to its keys; the batch
        then holds only the suffix, at absolute ``positions``."""
        tokens = batch["inputs"]
        B, S = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None] \
                .expand(B, S)
        x = L.embed_tokens(params["embed"], tokens, self.cfg)
        h = self._stack(params, x, positions=positions.long(),
                        caches=caches, seg_ids=batch.get("seg_ids"),
                        prefix_kv=prefix_kv)
        return h, caches

    def apply(self, params: Dict, batch: Dict, *,
              caches: Optional[Dict] = None,
              prefix_kv: Optional[Dict] = None) -> Tuple[torch.Tensor, Any]:
        """:meth:`hidden` with all-position logits ``(B, S, V)`` f32. (The
        reference also returns an aux loss, which only MoE stacks make.)"""
        h, caches = self.hidden(params, batch, caches=caches,
                                prefix_kv=prefix_kv)
        return self.logits(params, h), caches

    def prefill(self, params: Dict, batch: Dict, *,
                max_len: int = 0) -> Tuple[torch.Tensor, Any]:
        """Forward that fills fresh caches of ``max(max_len, S)`` positions
        (rings of the window for a windowed stack, the prompt's last ring
        positions in canonical ring phase); returns the last position's
        logits ``(B, 1, V)`` and the caches."""
        B, S = batch["inputs"].shape
        caches = self.init_cache(B, max(max_len, S))
        h, caches = self.hidden(params, batch, caches=caches)
        return self.logits(params, h[:, -1:]), caches

    def decode_step(self, params: Dict, batch: Dict, caches,
                    cache_index: torch.Tensor, *,
                    slot_mask: Optional[torch.Tensor] = None,
                    pages: Optional[Dict] = None) -> Tuple[torch.Tensor, Any]:
        """One-token step over contiguous lanes, or paged lanes when
        ``pages`` is given. batch ``{"inputs": (B, 1)}``; ``cache_index``
        (B,) tokens resident per row (the new token is written there);
        ``slot_mask`` (B,) rows allowed to write; ``pages`` ``{"bt": (B, n)
        int32, "width": lane width, "page_size": int}``. Returns ``(logits
        (B, 1, V) f32, caches)``; the caches are updated in place."""
        tokens = batch["inputs"]
        B = tokens.shape[0]
        ci = cache_index.reshape(-1).to(torch.int64).expand(B)
        positions = ci.reshape(-1, 1)
        x = L.embed_tokens(params["embed"], tokens, self.cfg)
        h = self._stack(params, x, positions=positions, caches=caches,
                        cache_index=ci, slot_mask=slot_mask, pages=pages)
        return self.logits(params, h), caches

    def mixed_hidden(self, params: Dict, batch: Dict, caches,
                     cache_index: torch.Tensor, n_new: torch.Tensor, *,
                     slot_mask: Optional[torch.Tensor] = None,
                     pages: Dict) -> Tuple[torch.Tensor, Any]:
        """:meth:`mixed_step` up to the final norm: ``(h (B, S, d),
        caches)``. The engine takes logits only at each row's last fresh
        column instead of all ``B * S``."""
        tokens = batch["inputs"]
        S = tokens.shape[1]
        ci = cache_index.reshape(-1).to(torch.int64)
        positions = ci[:, None] + torch.arange(S, device=tokens.device)[None]
        x = L.embed_tokens(params["embed"], tokens, self.cfg)
        h = self._stack(params, x, positions=positions, caches=caches,
                        cache_index=ci, slot_mask=slot_mask, pages=pages,
                        n_new=n_new.reshape(-1))
        return h, caches

    def mixed_step(self, params: Dict, batch: Dict, caches,
                   cache_index: torch.Tensor, n_new: torch.Tensor, *,
                   slot_mask: Optional[torch.Tensor] = None,
                   pages: Dict) -> Tuple[torch.Tensor, Any]:
        """One mixed step: up to ``S`` fresh tokens per row — prefill-chunk
        rows (``n_new > 1``), decode rows (``n_new == 1``) and inert rows
        (``n_new == 0``). batch ``{"inputs": (B, S)}`` left-aligned; row b's
        columns ``[0, n_new[b])`` sit at ``[cache_index[b], cache_index[b] +
        n_new[b])``. Returns all-position logits ``(B, S, V)`` and the
        caches (chunk K/V scattered in place after attention)."""
        h, caches = self.mixed_hidden(params, batch, caches, cache_index,
                                      n_new, slot_mask=slot_mask, pages=pages)
        return self.logits(params, h), caches
