"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1:2 pattern (rglru, rglru, local)
[arXiv:2402.19427; hf]."""
from repro_torch.models.common import ModelConfig, RGLRUConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
        n_heads=10, n_kv_heads=1, d_head=256, d_ff=7680, vocab_size=256000,
        act="geglu", norm="rmsnorm", rope=True, rope_theta=1e4,
        layer_pattern=("rglru", "rglru", "local"), local_window=2048,
        rglru=RGLRUConfig(lru_width=2560), tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", family="hybrid", n_layers=3,
        d_model=64, n_heads=4, n_kv_heads=1, d_head=16, d_ff=128,
        vocab_size=256, act="geglu", norm="rmsnorm", rope=True,
        layer_pattern=("rglru", "rglru", "local"), local_window=32,
        rglru=RGLRUConfig(lru_width=64), tie_embeddings=True,
        attn_chunk=16, remat="none",
    )
