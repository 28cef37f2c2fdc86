"""Model configuration shared by every architecture (``repro.models.common``
with torch dtypes)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.factorized import FactorizationConfig

__all__ = ["MoEConfig", "SSMConfig", "RGLRUConfig", "ModelConfig",
           "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the config's dtype strings)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual: bool = False
    d_ff_dense: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0
    conv_width: int = 4
    c_exponent: float = 8.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Same fields and defaults as ``repro.models.common.ModelConfig``."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: Optional[int] = None
    d_head: Optional[int] = None
    qkv_bias: bool = False
    act: str = "swiglu"
    norm: str = "rmsnorm"
    rope: bool = True
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    learned_pos: bool = False
    causal: bool = True
    sliding_window: Optional[int] = None
    layer_pattern: Optional[Tuple[str, ...]] = None
    local_window: int = 2048
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    n_codebooks: int = 1
    external_embeddings: bool = False
    factorization: FactorizationConfig = FactorizationConfig()
    weight_format: str = "dense"
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "nothing_saveable"
    attn_chunk: int = 512
    unroll_decode: bool = False
    constrain_acts: bool = False
    flash_block_dtype: str = "float32"
    kv_quant: bool = False
    decode_attn: str = "dense"
    decode_block_k: int = 128
    causal_wedge: bool = False
    n_encoder_layers: int = 0
    max_len: int = 131072

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None \
            else self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def block_kind(self, layer_idx: int) -> str:
        if self.layer_pattern is not None:
            return self.layer_pattern[layer_idx % len(self.layer_pattern)]
        if self.family == "ssm":
            return "ssd"
        return "attn"

    @property
    def uniform_layers(self) -> bool:
        return self.layer_pattern is None or len(set(self.layer_pattern)) == 1

    def n_params(self) -> int:
        """Approximate dense parameter count (embeddings + blocks), for 6ND
        (MoE: every expert, the router and arctic's dense FFN), as the
        reference counts it."""
        d, hd = self.d_model, self.head_dim
        p = self.vocab_size * d * (1 if self.tie_embeddings else 2) \
            * self.n_codebooks
        mults = 3 if self.act in ("swiglu", "geglu") else 2
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind in ("attn", "local"):
                p += d * hd * (self.n_heads + 2 * self.kv_heads) \
                    + self.n_heads * hd * d
                if self.moe is not None:
                    m = self.moe
                    p += d * m.n_experts  # router
                    p += m.n_experts * 3 * d * m.d_ff_expert
                    if m.dense_residual:
                        p += 3 * d * m.d_ff_dense
                else:
                    p += mults * d * self.d_ff
            elif kind == "ssd":
                s = self.ssm
                d_in = s.expand * d
                conv_ch = d_in + 2 * s.n_groups * s.d_state
                p += d * (2 * d_in + 2 * s.n_groups * s.d_state
                          + d_in // s.head_dim)
                p += conv_ch * s.d_conv + d_in * d
            elif kind == "rglru":
                w = self.rglru.lru_width or d
                p += 2 * d * w + w * self.rglru.conv_width + 2 * w + w * d
                p += mults * d * self.d_ff
        return p

    def n_active_params(self) -> int:
        """Active params per token (MoE: only ``top_k`` experts), for
        6 N_active D."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        per = 3 * self.d_model * m.d_ff_expert * self.n_layers
        return self.n_params() - m.n_experts * per + m.top_k * per
