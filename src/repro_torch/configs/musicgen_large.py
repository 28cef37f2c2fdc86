"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens, 4 codebooks; the EnCodec
frontend is a STUB (input_specs provides frame embeddings)
[arXiv:2306.05284; hf]."""
from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, d_head=64, d_ff=8192, vocab_size=2048,
        act="gelu", norm="layernorm", rope=False, n_codebooks=4,
        external_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab_size=64,
        act="gelu", norm="layernorm", rope=False, n_codebooks=4,
        external_embeddings=True, attn_chunk=16, remat="none",
    )
