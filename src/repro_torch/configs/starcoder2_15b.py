"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE, sliding-window 4096 [arXiv:2402.19173; hf]."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=4, d_head=128, d_ff=24576, vocab_size=49152,
        qkv_bias=True, act="gelu", norm="layernorm", rope=True,
        rope_theta=1e5, sliding_window=4096,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        qkv_bias=True, act="gelu", norm="layernorm", rope=True,
        sliding_window=32, attn_chunk=16, remat="none",
    )
