"""Feed-forward blocks: the dense GLU / plain MLP.

Counterpart of ``repro.models.mlp``'s dense half.  The mixture-of-experts
block (``MoEConfig``, ``moe_forward``) is ROADMAP queue 1 item 7 (b) and
raises until then.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import Initializer

__all__ = ["MLPConfig", "init_mlp", "mlp_forward", "MoEConfig", "moe_forward"]

MOE_TODO = "mixture-of-experts blocks wait for ROADMAP queue 1 item 7 (b)"


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    activation: str = "silu"      # 'silu' (SwiGLU), 'gelu' (GeGLU), 'gelu_plain', 'relu2'
    use_bias: bool = False


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name in ("gelu", "gelu_plain"):
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu(approximate=True)
    if name == "relu2":   # nemotron/minitron squared ReLU
        return torch.square(F.relu(x))
    raise ValueError(name)


def init_mlp(cfg: MLPConfig, ini: Initializer):
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_up": ini.param((d, f)),
        "w_down": ini.param((f, d)),
    }
    if cfg.activation in ("silu", "gelu"):
        p["w_gate"] = ini.param((d, f))
    if cfg.use_bias:
        p["b_up"] = ini.param((f,), init="zeros")
        p["b_down"] = ini.param((d,), init="zeros")
    return p


def mlp_forward(cfg: MLPConfig, params, x: torch.Tensor) -> torch.Tensor:
    up = torch.einsum("bsd,df->bsf", x, params["w_up"].to(x.dtype))
    if cfg.use_bias:
        up = up + params["b_up"].to(x.dtype)
    if "w_gate" in params:
        gate = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(x.dtype))
        h = _act(cfg.activation, gate) * up
    else:
        h = _act(cfg.activation, up)
    y = torch.einsum("bsf,fd->bsd", h, params["w_down"].to(x.dtype))
    if cfg.use_bias:
        y = y + params["b_down"].to(x.dtype)
    return y


class MoEConfig:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(MOE_TODO)


def moe_forward(*args, **kwargs):
    raise NotImplementedError(MOE_TODO)
