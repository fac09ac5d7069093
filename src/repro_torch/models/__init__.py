"""The LM model stack: dense and sliding-window attention transformers and RWKV-6."""
from .attention import AttentionConfig
from .common import Initializer, cross_entropy_loss
from .mlp import MLPConfig, MoEConfig
from .rwkv import RWKVConfig
from .transformer import Model, ModelConfig

__all__ = [
    "Model", "ModelConfig", "AttentionConfig", "MLPConfig", "MoEConfig", "RWKVConfig",
    "Initializer", "cross_entropy_loss",
]
