"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4 fine-grained [hf:databricks/dbrx-base; unverified]."""
from repro_torch.models.common import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=8, d_head=128, d_ff=10752, vocab_size=100352,
        act="swiglu", norm="rmsnorm", rope=True, rope_theta=5e5,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        act="swiglu", norm="rmsnorm", rope=True,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                      capacity_factor=2.0),
        attn_chunk=16, remat="none",
    )
