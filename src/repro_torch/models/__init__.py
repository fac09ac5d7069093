"""The LM model stack: dense, sliding-window and mixture-of-experts
attention transformers, RWKV-6, and the Mamba-2 hybrid."""
from .attention import AttentionConfig
from .common import Initializer, cross_entropy_loss
from .mamba import MambaConfig
from .mlp import MLPConfig, MoEConfig
from .rwkv import RWKVConfig
from .transformer import Model, ModelConfig

__all__ = [
    "Model", "ModelConfig", "AttentionConfig", "MLPConfig", "MoEConfig", "MambaConfig",
    "RWKVConfig", "Initializer", "cross_entropy_loss",
]
