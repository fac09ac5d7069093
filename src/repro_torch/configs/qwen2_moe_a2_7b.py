"""Qwen1.5-MoE-A2.7B: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        arch_type="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        block_unit=("moe",),
        n_experts=60,
        top_k=4,
        moe_d_ff=1408,
        n_shared_experts=4,
        use_bias=True,             # qwen attention qkv bias
        tie_embeddings=False,
        rope_theta=1000000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-reduced",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=512,
        block_unit=("moe",),
        n_experts=4,
        top_k=2,
        moe_d_ff=96,
        n_shared_experts=1,
        capacity_factor=8.0,   # no token drops -> deterministic smoke tests
        use_bias=True,
        tie_embeddings=False,
    )
