"""The LM model stack: dense and sliding-window attention transformers."""
from .attention import AttentionConfig
from .common import Initializer, cross_entropy_loss
from .mlp import MLPConfig, MoEConfig
from .transformer import Model, ModelConfig

__all__ = [
    "Model", "ModelConfig", "AttentionConfig", "MLPConfig", "MoEConfig",
    "Initializer", "cross_entropy_loss",
]
