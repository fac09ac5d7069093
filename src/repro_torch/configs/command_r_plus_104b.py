"""Command R+ (104B): 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000, bias-free, tied embeddings.  [hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        arch_type="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        block_unit=("attn",),
        use_bias=False,
        tie_embeddings=True,
        rope_theta=75000000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b-reduced",
        arch_type="dense",
        n_layers=2,
        d_model=192,
        n_heads=6,
        n_kv_heads=2,
        d_ff=384,
        vocab_size=512,
        block_unit=("attn",),
        use_bias=False,
        tie_embeddings=True,
    )
