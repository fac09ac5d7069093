"""Qwen2-VL-2B: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE (t/h/w rotary sections).  The dynamic-resolution vision encoder is
a stand-in, as in the reference: the model takes pre-computed patch
embeddings (``batch["vision_embeds"]``) through one projection.
[arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B-Instruct]
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        arch_type="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        block_unit=("attn",),
        mrope_sections=(16, 24, 24),   # head_dim 128 -> half 64 = 16+24+24
        n_vision_tokens=256,
        vision_grid=(16, 16),
        use_bias=True,
        tie_embeddings=True,
        rope_theta=1000000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-reduced",
        arch_type="vlm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        block_unit=("attn",),
        mrope_sections=(4, 6, 6),      # head_dim 32 -> half 16
        n_vision_tokens=16,
        vision_grid=(4, 4),
        use_bias=True,
        tie_embeddings=True,
    )
