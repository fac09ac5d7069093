"""Zamba2-7B: 81L d_model=3584, Mamba-2 backbone (ssm_state=64) with a SHARED
attention block (32H, kv=32, d_ff=14336) applied periodically, vocab=32000.
[arXiv:2411.15242]

Layout: 27 repeats of (mamba, mamba, shared_attn) = 81 layers; the shared_attn
weights are a single copy reused at every application (zamba's weight sharing).
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        arch_type="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        block_unit=("mamba", "mamba", "shared_attn"),
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-reduced",
        arch_type="hybrid",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        block_unit=("mamba", "mamba", "shared_attn"),
        ssm_state=16,
        ssm_head_dim=32,
        ssm_expand=2,
        ssm_chunk=16,
        tie_embeddings=True,
    )
