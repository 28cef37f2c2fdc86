"""mamba2-370m [ssm]: 48L d_model=1024 (attn-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060; unverified]."""
from repro_torch.models.common import ModelConfig, SSMConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
        n_heads=1, d_ff=0, vocab_size=50280, act="gelu", norm="rmsnorm",
        rope=False, ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=1, d_ff=0, vocab_size=256, act="gelu", norm="rmsnorm",
        rope=False, ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
        tie_embeddings=True, remat="none",
    )
