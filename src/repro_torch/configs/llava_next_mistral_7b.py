"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — Mistral backbone; anyres tiling frontend is a STUB
(input_specs provides precomputed patch embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_head=128, d_ff=14336, vocab_size=32000,
        act="swiglu", norm="rmsnorm", rope=True, rope_theta=1e6,
        external_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke", family="vlm", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
        vocab_size=256, act="swiglu", norm="rmsnorm", rope=True,
        external_embeddings=True, attn_chunk=16, remat="none",
    )
