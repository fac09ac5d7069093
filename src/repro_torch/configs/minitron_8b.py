"""Minitron-8B: 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000 —
pruned Nemotron-4 (squared-ReLU MLP, untied embeddings).  [arXiv:2407.14679]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        arch_type="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=256000,
        block_unit=("attn",),
        activation="relu2",
        tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-reduced",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        block_unit=("attn",),
        activation="relu2",
        tie_embeddings=False,
    )
