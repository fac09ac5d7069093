"""Model building blocks: the parameter initializer, norms, rotary
embeddings and the loss.

Counterpart of ``repro.models.common`` on one device.  The reference tags
every parameter and activation with logical sharding axes
(``logical_constraint``, ``axis_rules``, ``LogicalAxes`` and the
initializer's specs and shapes modes); on one device they are the identity,
so the port has none of them.  The sharded engine
(``launch/distributed.py``) keeps each node on one device; the within-node
layouts they steer are ROADMAP queue 1 item 8 (b).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.rms_norm.ref import rms_norm_ref

__all__ = [
    "Initializer", "rms_norm", "layer_norm", "softcap", "rope_frequencies", "apply_rope",
    "make_mrope_positions", "apply_mrope", "cross_entropy_loss",
]


class Initializer:
    """Draws parameters from an explicit ``torch.Generator`` (the
    reference's ``"params"`` mode).

    ``lead`` is prepended to every parameter's shape: a model's block
    parameters are drawn stacked over their ``(repeats,)`` axis at once.
    A normal init scales by 1/sqrt(fan_in) of the per-layer shape, as the
    reference does.  The generator's numbers are not ``jax.random``'s: the
    parity tests carry the reference's parameters over through numpy.
    """

    def __init__(self, generator: torch.Generator, dtype=torch.float32, device=None,
                 lead: Tuple[int, ...] = ()):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else generator.device
        self.lead = tuple(lead)

    def stacked(self, n: int) -> "Initializer":
        """The same generator, drawing ``(n, ...)``-stacked parameters."""
        return Initializer(self.generator, self.dtype, self.device, (n,) + self.lead)

    def param(self, shape: Sequence[int], init: str = "normal",
              scale: Optional[float] = None, dtype=None) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        full = self.lead + shape
        dt = dtype or self.dtype
        if init == "zeros":
            return torch.zeros(full, dtype=dt, device=self.device)
        if init == "ones":
            return torch.ones(full, dtype=dt, device=self.device)
        if init == "normal":
            fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
            s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        elif init == "embed":
            s = scale if scale is not None else 1.0
        else:
            raise ValueError(init)
        x = torch.randn(full, generator=self.generator, device=self.device)
        return x.mul_(s).to(dt)


# --------------------------------------------------------------------------
# norms / activations
# --------------------------------------------------------------------------
# the models' norm is the plain RMSNorm, as repro.models.common.rms_norm
# (the fused kernel behind api.call("rms_norm", ...) is opt-in, as there)
rms_norm = rms_norm_ref


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32, cast back to x's dtype.  No model calls it, in
    the port as in the reference: every block normalises with ``rms_norm``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap), in fp32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The half-split rotation, in fp32 (x promotes against the fp32
    angles), cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)   # (half,)
    ang = positions[..., None].float() * freqs                      # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    return _rotate(x, cos, sin)


def make_mrope_positions(batch: int, seq: int, n_vision: int, grid: Tuple[int, int],
                         device=None) -> torch.Tensor:
    """Qwen2-VL's M-RoPE positions (3, B, S) int32: (temporal, height, width).

    The first ``n_vision`` tokens are the vision block: temporal position 0
    and their (h, w) grid coordinates.  Text tokens get equal t, h and w
    positions, counting from ``max(gh, gw)``.
    """
    gh, gw = grid
    if gh * gw != n_vision:
        raise ValueError(f"vision grid {grid} does not hold {n_vision} tokens")
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=device)  # noqa: E731
    text = ar(seq - n_vision) + max(gh, gw)
    pos = torch.stack([
        torch.cat([torch.zeros(n_vision, dtype=torch.int32, device=device), text]),
        torch.cat([ar(gh).repeat_interleave(gw), text]),
        torch.cat([ar(gw).repeat(gh), text]),
    ])                                                              # (3, S)
    return pos[:, None, :].expand(3, batch, seq)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE: the rotary half-dim is split into (t, h, w)
    sections, each rotated by its own position stream.  x: (B, S, H, hd);
    positions3: (3, B, S)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to half of {x.shape[-1]}")
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)  # (half,)
    # each frequency's position stream, by section; built from views (an
    # index tensor made per call would copy from the host and stall it)
    pos = torch.cat([positions3[i, ..., None].expand(*positions3.shape[1:], n)
                     for i, n in enumerate(sections)], dim=-1)      # (B, S, half)
    ang = pos.float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    return _rotate(x, cos, sin)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level cross entropy, fp32. logits (..., V), targets (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
