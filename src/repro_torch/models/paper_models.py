"""The paper's four evaluation workloads [25-28] as runnable models
(``repro.models.paper_models``).

- ``bert`` [28]: bidirectional encoder (BERT family), learned positions.
- ``vit`` [25]: encoder over patch embeddings (``batch["embeds"]``, the
  frontend stub), learned positions in the tree but none added (the
  reference's ``Model`` adds no positions to external embeddings).
- ``mt`` [26]: encoder-decoder (R-Drop's base MT setup).
- ``s2t`` [27]: fairseq-S2T-style encoder-decoder over fbank frames, the
  conv-subsample frontend stubbed as an ``(80, d)`` projection.

The encoders are the port's :class:`~repro_torch.models.transformer.Model`
with ``causal=False``; :class:`EncDecModel` adds cross-attention through
the same ``attention_block`` (its ``kv=`` path). Every linear is
factorization-eligible with per-side dictionaries (``enc_attn``,
``enc_ffn``, ``dec_attn``, ``dec_xattn``, ``dec_ffn``), the paper's
"separate W_S per encoder/decoder and attention/FFN" rule, so
``core/factorized.py::compress_model_params`` turns any of them into the
T-REX streams and the compressed linears run through the DMM and SMM
kernels on the card.

The reference's quirks are kept (ROADMAP, "Faults of the reference"):
``encode`` adds ``pos[:S]`` after ``embed_tokens``, which has already
added the rows of ``src_positions`` when the batch gives them; the decoder
adds no positions at all.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.factorized import DictionaryBank, FactorizationConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Model

__all__ = ["paper_model_config", "EncDecModel", "build_paper_model",
           "PAPER_MODELS"]

PAPER_MODELS = ("bert", "vit", "mt", "s2t")


def paper_model_config(name: str, factorized: bool = True) -> ModelConfig:
    """The reference's published widths for ``name`` (``min_dim`` 128,
    the default rank and nnz ratios; bf16 compute over f32 params)."""
    f = FactorizationConfig(enabled=factorized, min_dim=128)
    if name == "bert":
        return ModelConfig(
            name="trex-bert", family="encoder", n_layers=12, d_model=768,
            n_heads=12, d_ff=3072, vocab_size=30522, act="gelu",
            norm="layernorm", rope=False, learned_pos=True, causal=False,
            max_len=512, factorization=f, remat="none", attn_chunk=128)
    if name == "vit":
        return ModelConfig(
            name="trex-vit", family="encoder", n_layers=12, d_model=384,
            n_heads=6, d_ff=1536, vocab_size=1000, act="gelu",
            norm="layernorm", rope=False, learned_pos=True, causal=False,
            external_embeddings=True, max_len=512, factorization=f,
            remat="none", attn_chunk=128)
    if name == "mt":
        return ModelConfig(
            name="trex-mt", family="encdec", n_layers=6, n_encoder_layers=6,
            d_model=512, n_heads=8, d_ff=2048, vocab_size=32000, act="gelu",
            norm="layernorm", rope=False, learned_pos=True, causal=True,
            max_len=512, factorization=f, remat="none", attn_chunk=128)
    if name == "s2t":
        return ModelConfig(
            name="trex-s2t", family="encdec", n_layers=6, n_encoder_layers=12,
            d_model=256, n_heads=4, d_ff=2048, vocab_size=10000, act="gelu",
            norm="layernorm", rope=False, learned_pos=True, causal=True,
            external_embeddings=True,  # fbank frontend stub
            max_len=1024, factorization=f, remat="none", attn_chunk=128)
    raise ValueError(name)


class EncDecModel:
    """Compact encoder-decoder (mt, s2t): Python loops over at most 12 + 6
    layers, parameters ``{"encoder": {"layer_XX": ...}, "decoder":
    {"layer_XX": ...}}`` without an L axis, as the reference lays them
    out (so ``models/bridge.py`` hands a reference tree over unchanged).
    Runs at model level (``encode``, ``decode``, ``loss``), as the
    reference's does: no engine serves it."""

    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None):
        if not cfg.n_encoder_layers:
            raise ValueError(f"{cfg.name}: EncDecModel needs "
                             "n_encoder_layers > 0 (encoders are Model)")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> Dict:
        """Random parameters in the reference's layout and distributions,
        drawn on ``self.device`` from a ``torch.Generator`` seeded with
        ``seed``: the source embedding (``init_embedding``: tokens unless
        the source is external, learned positions), the decoder's token
        table ``N(0, 0.02^2)``, the head ``N(0, 1/d)``, s2t's frontend
        ``(80, d)`` ``N(0, 1/81)``, the layers, the two final norms and
        the shared dictionaries."""
        cfg = self.cfg
        g = torch.Generator(device=self.device).manual_seed(seed)
        dt, d = cfg.params_dtype, cfg.d_model
        bank = DictionaryBank(cfg.factorization, dt) \
            if cfg.factorization.enabled else None

        def normal(shape, std):
            return torch.empty(shape, dtype=dt, device=self.device).normal_(
                0.0, std, generator=g)

        p: Dict = {"embed": L.init_embedding(g, cfg),
                   "dec_embed": {"tok": normal((cfg.vocab_size, d), 0.02)},
                   "lm_head": L.init_lm_head(g, cfg)}
        if cfg.external_embeddings:  # S2T: fbank(80) -> d stub projection
            p["frontend"] = {"w": normal((80, d), 1.0 / 9.0)}

        def norm():
            return L.init_norm(cfg, (), self.device)

        p["encoder"] = {f"layer_{i:02d}": {
            "norm1": norm(), "norm2": norm(),
            "attn": L.init_attention(g, cfg, bank, prefix="enc_attn"),
            "ffn": L.init_ffn(g, cfg, bank, prefix="enc_ffn"),
        } for i in range(cfg.n_encoder_layers)}
        p["decoder"] = {f"layer_{i:02d}": {
            "norm1": norm(), "norm2": norm(), "norm3": norm(),
            "attn": L.init_attention(g, cfg, bank, prefix="dec_attn"),
            "xattn": L.init_attention(g, cfg, bank, prefix="dec_xattn"),
            "ffn": L.init_ffn(g, cfg, bank, prefix="dec_ffn"),
        } for i in range(cfg.n_layers)}
        p["enc_norm"] = norm()
        p["dec_norm"] = norm()
        if bank is not None:
            p["dicts"] = bank.dicts
        return p

    def encode(self, p: Dict, batch: Dict,
               sparse_train: bool = False) -> torch.Tensor:
        """The source ``(B, S, d)`` memory: ``batch["src"]`` token ids (or
        s2t's ``batch["src_feats"]`` ``(B, S, 80)`` through the frontend),
        plus ``pos[:S]``, through the bidirectional encoder with
        ``batch["src_seg"]`` (0 on a padded source) and the final norm."""
        cfg = self.cfg
        dicts = p.get("dicts")
        dt = cfg.compute_dtype
        if cfg.external_embeddings:
            x = batch["src_feats"].to(dt) @ p["frontend"]["w"].to(dt)
        else:
            x = L.embed_tokens(p["embed"], batch["src"], cfg,
                               positions=batch.get("src_positions"))
        if cfg.learned_pos and "pos" in p["embed"]:
            x = x + p["embed"]["pos"][None, :x.shape[1]].to(x.dtype)
        seg = batch.get("src_seg")
        B, S = x.shape[0], x.shape[1]
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        enc_cfg = dataclasses.replace(cfg, causal=False)
        for i in range(cfg.n_encoder_layers):
            lp = p["encoder"][f"layer_{i:02d}"]
            x = x + L.attention_block(
                lp["attn"], L.apply_norm(lp["norm1"], x), cfg=enc_cfg,
                dicts=dicts, positions=pos, seg_ids=seg, window=None,
                sparse_train=sparse_train, prefix="enc_attn")
            x = x + L.ffn_block(lp["ffn"], L.apply_norm(lp["norm2"], x),
                                cfg=cfg, dicts=dicts, prefix="enc_ffn",
                                sparse_train=sparse_train)
        return L.apply_norm(p["enc_norm"], x)

    def decode(self, p: Dict, memory: torch.Tensor, batch: Dict,
               sparse_train: bool = False) -> torch.Tensor:
        """f32 logits ``(B, St, V)`` of the target ``batch["tgt"]``
        (teacher-forced): causal self-attention, cross-attention over
        ``memory`` (masked by ``batch["src_seg"]``), the FFN, the final
        norm and the head."""
        cfg = self.cfg
        dicts = p.get("dicts")
        tgt = batch["tgt"]
        B, St = tgt.shape
        x = L.take_rows(p["dec_embed"]["tok"], tgt).to(cfg.compute_dtype)
        pos = torch.arange(St, device=x.device)[None].expand(B, St)
        seg_kv = batch.get("src_seg")
        for i in range(cfg.n_layers):
            lp = p["decoder"][f"layer_{i:02d}"]
            x = x + L.attention_block(
                lp["attn"], L.apply_norm(lp["norm1"], x), cfg=cfg,
                dicts=dicts, positions=pos, window=None,
                sparse_train=sparse_train, prefix="dec_attn")
            x = x + L.attention_block(
                lp["xattn"], L.apply_norm(lp["norm2"], x), cfg=cfg,
                dicts=dicts, positions=pos, window=None, kv=memory,
                seg_kv=seg_kv, sparse_train=sparse_train, prefix="dec_xattn")
            x = x + L.ffn_block(lp["ffn"], L.apply_norm(lp["norm3"], x),
                                cfg=cfg, dicts=dicts, prefix="dec_ffn",
                                sparse_train=sparse_train)
        x = L.apply_norm(p["dec_norm"], x)
        return x.float() @ p["lm_head"]["w"].float()

    def loss(self, p: Dict, batch: Dict, sparse_train: bool = False
             ) -> Tuple[torch.Tensor, Dict]:
        """Mean cross-entropy of ``batch["labels"]`` (optional
        ``batch["weights"]``) over the decoder's logits: ``(xent,
        {"xent", "loss"})``."""
        memory = self.encode(p, batch, sparse_train)
        logits = self.decode(p, memory, batch, sparse_train)
        xe = L.cross_entropy(logits, batch["labels"], batch.get("weights"))
        return xe, {"xent": xe, "loss": xe}


def build_paper_model(name: str, factorized: bool = True,
                      device: Optional[Union[str, torch.device]] = None):
    """``(model, cfg)``: :class:`Model` for the encoders (bert, vit),
    :class:`EncDecModel` for the encoder-decoders (mt, s2t)."""
    cfg = paper_model_config(name, factorized)
    if cfg.family == "encdec":
        return EncDecModel(cfg, device), cfg
    return Model(cfg, device), cfg
