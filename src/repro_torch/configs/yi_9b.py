"""Yi-9B: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-architecture GQA decoder.  [arXiv:2403.04652]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        arch_type="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        block_unit=("attn",),
        rope_theta=5000000.0,
        tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-reduced",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        block_unit=("attn",),
        tie_embeddings=False,
    )
