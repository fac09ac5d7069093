"""Model building blocks: logical parameter axes, the parameter
initializer, norms, rotary embeddings and the loss.

Counterpart of ``repro.models.common``.  Every parameter is drawn with the
reference's *logical* axis names (``Initializer.param(shape, axes)``), and
``Model.param_specs()`` returns them as a tree of :class:`LogicalAxes`; a
rules table (``axis_rules``, set by the sharding profile) maps the names to
mesh axes, and :func:`resolve_specs` turns the tree into per-dim specs, a
name that does not divide its dim staying replicated and a mesh axis used
once a leaf.  The sharded engine (``launch/distributed.py``) lays the state
out by those specs.  The reference's ``logical_constraint`` (a sharding hint
on activations for GSPMD) does not come over: the port has no partitioner,
so its tensor-parallel forward names every movement explicitly, through the
model group the engine passes down (``tp=``; ``launch/mesh.py``'s
``ModelGroup``), and :func:`cross_entropy_loss` takes vocab-sharded logits
with that group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Sequence, Tuple

import torch

from ..kernels.rms_norm.ref import rms_norm_ref

__all__ = [
    "LogicalAxes", "axis_rules", "resolve_specs", "Initializer", "rms_norm", "sharded_rms_norm",
    "layer_norm", "softcap", "rope_frequencies", "apply_rope",
    "make_mrope_positions", "apply_mrope", "cross_entropy_loss",
]


# --------------------------------------------------------------------------
# logical axis rules
# --------------------------------------------------------------------------
class _Rules(threading.local):
    def __init__(self):
        self.acts: dict = {}
        self.params: dict = {}
        self.mesh = None


_RULES = _Rules()


@contextlib.contextmanager
def axis_rules(rules: dict, mesh=None, param_rules: Optional[dict] = None):
    """Activate logical -> mesh axis rules for the enclosed region (this
    thread's).  ``rules`` are the activation rules, ``param_rules``
    (default ``rules``) those :func:`resolve_specs` reads; ``mesh`` (any
    object with ``axis_names`` and ``devices.shape``) enables the
    divisibility check."""
    old = (_RULES.acts, _RULES.params, _RULES.mesh)
    _RULES.acts = dict(rules)
    _RULES.params = dict(param_rules if param_rules is not None else rules)
    _RULES.mesh = mesh
    try:
        yield
    finally:
        _RULES.acts, _RULES.params, _RULES.mesh = old


def _axis_size(mesh_axes) -> int:
    mesh = _RULES.mesh
    if mesh is None:
        return 1
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    size = 1
    for a in ((mesh_axes,) if isinstance(mesh_axes, str) else mesh_axes):
        size *= sizes[a]
    return size


def _resolve_axes(names: Sequence[Optional[str]], shape: Optional[Sequence[int]] = None,
                  table: Optional[dict] = None) -> Tuple:
    """Logical names -> a spec tuple of mesh axes.  Each mesh axis is used
    at most once a spec (the first divisible dim wins: Qwen2-MoE's 60
    experts do not divide a 16-way model axis, so its expert-hidden dim
    shards instead); a dim the axis does not divide stays replicated."""
    table = _RULES.acts if table is None else table
    out = []
    used: set = set()
    for i, name in enumerate(names):
        mesh_axes = table.get(name) if name else None
        if mesh_axes is not None:
            key = tuple(mesh_axes) if isinstance(mesh_axes, (tuple, list)) else (mesh_axes,)
            if any(a in used for a in key):
                mesh_axes = None
            elif shape is not None and shape[i] % max(1, _axis_size(mesh_axes)) != 0:
                mesh_axes = None
            else:
                used.update(key)
        out.append(mesh_axes)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class LogicalAxes:
    """A tree *leaf*: one parameter's per-dim logical names and shape."""

    names: Tuple[Optional[str], ...]
    shape: Tuple[int, ...] = ()

    def spec(self) -> Tuple:
        return _resolve_axes(self.names, self.shape if self.shape else None, _RULES.params)


def resolve_specs(spec_tree: Any, prefix: Tuple = ()) -> Any:
    """A :class:`LogicalAxes` tree -> a tree of spec tuples under the
    active *param* rules; ``prefix`` is prepended (the node axis of a
    node-stacked state).  A leaf that is not ``LogicalAxes`` gets
    ``prefix`` alone."""
    if isinstance(spec_tree, dict):
        return {k: resolve_specs(v, prefix) for k, v in spec_tree.items()}
    if isinstance(spec_tree, LogicalAxes):
        return tuple(prefix) + spec_tree.spec()
    return tuple(prefix)


# --------------------------------------------------------------------------
# the parameter initializer
# --------------------------------------------------------------------------
class Initializer:
    """Draws parameters from an explicit ``torch.Generator`` (the
    reference's ``"params"`` mode), or, with ``mode="specs"``, returns each
    parameter's :class:`LogicalAxes` instead (the reference's ``"specs"``
    mode; no generator, nothing drawn).

    ``lead`` is prepended to every parameter's shape, and ``lead_axes`` to
    its axes: a model's block parameters are drawn stacked over their
    ``(repeats,)`` axis at once, named ``"layers"``.  A normal init scales
    by 1/sqrt(fan_in) of the per-layer shape, as the reference does.  The
    generator's numbers are not ``jax.random``'s: the parity tests carry the
    reference's parameters over through numpy.
    """

    def __init__(self, generator: Optional[torch.Generator], dtype=torch.float32, device=None,
                 lead: Tuple[int, ...] = (), lead_axes: Tuple[Optional[str], ...] = (),
                 mode: str = "params"):
        if mode not in ("params", "specs"):
            raise ValueError(mode)
        self.generator = generator
        self.dtype = dtype
        self.device = (torch.device(device) if device is not None
                       else None if generator is None else generator.device)
        self.lead = tuple(lead)
        self.lead_axes = tuple(lead_axes)
        self.mode = mode

    def stacked(self, n: int) -> "Initializer":
        """The same generator, drawing ``(n, ...)``-stacked parameters."""
        return Initializer(self.generator, self.dtype, self.device, (n,) + self.lead,
                           ("layers",) + self.lead_axes, self.mode)

    def param(self, shape: Sequence[int], axes: Sequence[Optional[str]], init: str = "normal",
              scale: Optional[float] = None, dtype=None):
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"{len(axes)} axis names for shape {shape}")
        if self.mode == "specs":
            return LogicalAxes(self.lead_axes + axes, self.lead + shape)
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


def sharded_rms_norm(x: torch.Tensor, weight: torch.Tensor, tp, width: int,
                     eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` of rows whose ``width`` channels lie over a model group,
    this rank holding ``x.shape[-1]`` of them and ``weight``'s matching
    part: the mean of squares is the fp32 sum of the group's shards
    (``tp.sum_shards``, whose backward sums too: the statistic feeds every
    rank's own channels) divided by ``width``.  Output in x's dtype."""
    xf = x.float()
    var = tp.sum_shards((xf * xf).sum(dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


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
                       mask: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """Token-level cross entropy, fp32. logits (..., V), targets (...).

    With ``tp`` (a model group) the logits are this rank's contiguous
    vocabulary shard, shard ``tp.index`` of ``tp.size``: the max, the sum of
    exponentials and the target's logit are each all-reduced over the
    group, so every rank gets the same loss."""
    logits = logits.float()
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    else:
        rows = logits.shape[-1]
        top = tp.all_reduce(logits.detach().amax(dim=-1), op="max")
        logz = torch.log(tp.reduce_from(torch.exp(logits - top[..., None]).sum(dim=-1))) + top
        local = targets.long() - tp.index * rows
        inside = (local >= 0) & (local < rows)
        gold = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])[..., 0]
        gold = tp.reduce_from(gold * inside)
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
