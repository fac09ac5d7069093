"""Snowflake Arctic (base): 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 with a parallel dense residual FFN.
[hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        arch_type="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,                 # dense residual branch hidden
        vocab_size=32000,
        block_unit=("moe",),
        n_experts=128,
        top_k=2,
        moe_d_ff=4864,             # routed expert hidden
        dense_residual=True,       # arctic's dense-MoE hybrid residual
        tie_embeddings=False,
        rope_theta=10000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-reduced",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        block_unit=("moe",),
        n_experts=4,
        top_k=2,
        moe_d_ff=256,
        dense_residual=True,
        capacity_factor=8.0,   # no token drops -> deterministic smoke tests
        tie_embeddings=False,
    )
