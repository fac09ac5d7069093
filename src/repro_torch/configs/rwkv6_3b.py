"""RWKV-6 (Finch) 3B: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536 — data-dependent decay linear attention.  [arXiv:2404.05892]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        arch_type="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,            # d_model / rwkv head_dim(64)
        n_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        block_unit=("rwkv",),
        tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-reduced",
        arch_type="ssm",
        n_layers=2,
        d_model=128,
        n_heads=2,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        block_unit=("rwkv",),
        tie_embeddings=False,
    )
