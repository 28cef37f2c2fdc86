"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 —
llama-arch GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_head=128, d_ff=20480, vocab_size=64000,
        act="swiglu", norm="rmsnorm", rope=True, rope_theta=5e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        act="swiglu", norm="rmsnorm", rope=True, attn_chunk=16, remat="none",
    )
