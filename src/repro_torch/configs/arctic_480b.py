"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base;
hf]."""
from repro_torch.models.common import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, d_head=128, d_ff=4864, vocab_size=32000,
        act="swiglu", norm="rmsnorm", rope=True, rope_theta=1e6,
        moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                      dense_residual=True, d_ff_dense=7168),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=64, vocab_size=256,
        act="swiglu", norm="rmsnorm", rope=True,
        # high capacity factor: decode batches are tiny (2 tokens) and the
        # consistency tests need drop-free routing
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                      dense_residual=True, d_ff_dense=128,
                      capacity_factor=8.0),
        attn_chunk=16, remat="none",
    )
