"""HuBERT X-Large: 48L d_model=1280 16H d_ff=5120 vocab=504 (codebook units),
encoder-only (bidirectional attention, same arch as wav2vec2).  The conv
feature encoder is a stand-in, as in the reference: the model takes
512-dim frame features (``batch["frames"]``) through one projection.
[arXiv:2106.07447; hf:facebook/hubert-xlarge-ll60k]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        arch_type="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        block_unit=("attn",),
        causal=False,
        head="frame",
        activation="gelu_plain",
        use_bias=True,
        audio_frontend_dim=512,
        tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-reduced",
        arch_type="audio",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=64,
        block_unit=("attn",),
        causal=False,
        head="frame",
        activation="gelu_plain",
        use_bias=True,
        audio_frontend_dim=32,
        tie_embeddings=False,
    )
