"""Gemma-2 2B: 26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216
vocab=256000; alternating local (sliding-window 4096) + global attention,
attention and final-logit soft-capping, RMSNorm(1+w), post-block norms,
GeGLU, embedding scaling.  [arXiv:2408.00118]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        arch_type="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        block_unit=("local", "attn"),
        sliding_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        norm_plus_one=True,
        use_post_norm=True,
        scale_embeddings=True,
        activation="gelu",
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-reduced",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_unit=("local", "attn"),
        sliding_window=16,
        attn_softcap=50.0,
        logit_softcap=30.0,
        norm_plus_one=True,
        use_post_norm=True,
        scale_embeddings=True,
        activation="gelu",
        tie_embeddings=True,
    )
