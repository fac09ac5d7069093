"""Feed-forward blocks: the dense GLU / plain MLP and the mixture of experts.

Counterpart of ``repro.models.mlp``.  The MoE is the reference's
Switch-style capacity dispatch: a router in fp32, top-k experts per token
with their gates renormalised, each (token, k) entry queued at its
expert in token-major order (an exclusive prefix count), entries past the
capacity dropped into a trash row, the experts' GLUs as batched GEMMs over
(expert, slot), and a gather that combines each token's gated outputs.
Shared experts (Qwen2-MoE) and a parallel dense branch (Arctic) are added
on top.

Dispatch layouts:
  'auto'           one set of queues over all tokens;
  'gather_tokens'  the reference replicates the tokens first; on one device
                   that is the identity, so this is 'auto' bit for bit;
  'grouped'        ``dispatch_groups`` groups of tokens, each with its own
                   queues and a local capacity (one group when the token
                   count is not a multiple); the groups' slots go through
                   the experts' GEMMs together.

The dispatch writes each kept (expert, slot) once, so its scatter is an
``index_put_`` without accumulation: the reference adds each token into a
zero queue (0 + x = x, the same bits), and only the discarded trash row
takes several writes, in no set order.  No atomics are needed.

``moe_forward`` takes ``tp``, a model group (``launch/mesh.py``'s
``ModelGroup``), for a node spread tensor-parallel over M ranks as the 'tp'
profile lays it out.  An expert leaf uses the model axis once: on
``experts`` where the expert count divides by M (a rank holds E / M whole
experts: Qwen1.5-MoE 30 of 60), else on the experts' hidden dim.  Every
rank routes every token as the whole model does (the same capacity, the
same stable top-k, the same queue positions): the router's logits are
column-parallel on ``experts`` and all-gathered (``gather_from``: the
router losses, which every rank computes whole, give every rank the same
gradient, of which a rank keeps its columns) -- or computed whole where
the router fell back to replicated.  The renormalised gates feed the
rank's experts only, so they pass ``copy_to``: their gradient is summed
over the ranks before it joins the router losses'.  The rank dispatches
the entries of its own experts (the rest go to the trash slot), runs its
experts' GEMMs on ``copy_to`` of the tokens, combines its gated outputs
and all-reduces them (``reduce_from``).  The shared experts and a dense
residual are Megatron MLPs (``mlp_forward(..., tp=)``).

``moe_forward`` also takes ``data``, the ranks that split one logical
batch over D data ranks, each holding a contiguous block of the rows in
data-rank order: the ``NodeMesh`` of the mesh-sharded serve job, or the
``DataGroup`` of a '2d' training node (``launch/mesh.py``).  The MoE queues
the whole batch once, as the reference's one logical batch is queued: the
capacity is the whole batch's (D times the rank's tokens), and a rank's
queue positions start after the entries that the data ranks below it route
to each expert (``sum_below`` of the E per-expert counts, one exchange of
E ints a layer).  So the kept entries, and the answer, do not depend on D.
In training (``return_aux``) the router losses are the whole batch's too:
the z-loss is a mean over all D ranks' tokens and the load-balance loss
multiplies the whole batch's expert fractions, the per-expert counts summed
over the data ranks first.  A rank returns its share of them -- its own
tokens' terms of the z-loss mean, and the product with its own tokens'
part of the mean router probabilities -- so that the shares sum over the
ranks to the whole batch's losses, and their gradients to the whole
batch's gradient, with no term counted D times.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .common import Initializer

__all__ = ["MLPConfig", "init_mlp", "mlp_forward", "MoEConfig", "init_moe", "moe_forward",
           "moe_routing"]


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
        "w_up": ini.param((d, f), ("embed", "ffn")),
        "w_down": ini.param((f, d), ("ffn", "embed")),
    }
    if cfg.activation in ("silu", "gelu"):
        p["w_gate"] = ini.param((d, f), ("embed", "ffn"))
    if cfg.use_bias:
        p["b_up"] = ini.param((f,), ("ffn",), init="zeros")
        p["b_down"] = ini.param((d,), ("embed",), init="zeros")
    return p


def mlp_forward(cfg: MLPConfig, params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The GLU / plain MLP.  ``tp`` (a model group) runs the rank's share of
    the hidden units of a tensor-parallel node: ``w_down``'s partial sums
    are all-reduced in fp32 before ``b_down``.  Where the hidden dim fell
    back to replicated the layer runs whole, with no collective."""
    sharded = tp is not None and params["w_up"].shape[-1] != cfg.d_ff
    if sharded:
        x = tp.copy_to(x)
    up = torch.einsum("bsd,df->bsf", x, params["w_up"].to(x.dtype))
    if cfg.use_bias:
        up = up + params["b_up"].to(x.dtype)
    if "w_gate" in params:
        gate = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(x.dtype))
        h = _act(cfg.activation, gate) * up
    else:
        h = _act(cfg.activation, up)
    y = torch.einsum("bsf,fd->bsd", h, params["w_down"].to(x.dtype))
    if sharded:
        y = tp.reduce_from(y)
    if cfg.use_bias:
        y = y + params["b_down"].to(x.dtype)
    return y


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                      # per-expert hidden
    n_experts: int
    top_k: int
    n_shared_experts: int = 0      # qwen2-moe: always-on shared experts
    dense_residual: bool = False   # arctic: parallel dense FFN branch
    dense_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    activation: str = "silu"
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    dispatch_layout: str = "auto"  # 'auto' | 'gather_tokens' | 'grouped'
    dispatch_groups: int = 16


def init_moe(cfg: MoEConfig, ini: Initializer):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": ini.param((d, e), ("embed", "experts")),
        "w_gate": ini.param((e, d, f), ("experts", "embed", "ffn")),
        "w_up": ini.param((e, d, f), ("experts", "embed", "ffn")),
        "w_down": ini.param((e, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(MLPConfig(d, f * cfg.n_shared_experts, cfg.activation), ini)
    if cfg.dense_residual:
        p["dense"] = init_mlp(MLPConfig(d, cfg.dense_d_ff or f, cfg.activation), ini)
    return p


def _groups_and_capacity(cfg: MoEConfig, n_tok: int):
    """The layout's token groups and each group's capacity, as the
    reference's ``moe_forward`` computes them (a host int)."""
    groups = cfg.dispatch_groups if cfg.dispatch_layout == "grouped" else 1
    if n_tok % max(groups, 1):
        groups = 1
    per = n_tok // groups
    capacity = int(max(cfg.top_k, cfg.capacity_factor * per * cfg.top_k / cfg.n_experts))
    return groups, min(capacity, per)


def _router_logits(cfg: MoEConfig, router, tokens, tp=None):
    """tokens (G, T, d) -> the router's logits (G, T, E), fp32; with ``tp``
    and a router sharded on ``experts``, the rank's columns all-gathered."""
    if tp is not None and router.shape[-1] != cfg.n_experts:
        part = torch.einsum("gtd,de->gte", tp.copy_to(tokens).float(), router.float())
        return tp.gather_from(part, 2)
    return torch.einsum("gtd,de->gte", tokens.float(), router.float())


def _route(cfg: MoEConfig, router, tokens, capacity: int, tp=None, data=None):
    """tokens (G, T, d) -> logits and probs (G, T, E) fp32, gates, experts,
    queue positions and the kept mask, each (G, T, k).

    Top-k is a stable descending sort, so equal probabilities rank by
    expert index, as ``lax.top_k`` ranks them.  ``tp`` and ``data``: see
    the module docstring (the gates come back through ``copy_to``)."""
    logits = _router_logits(cfg, router, tokens, tp)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[..., :cfg.top_k], expert_idx[..., :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    g, t, k = expert_idx.shape
    # (G, E, T*k), entries in token-major order along the last dim: the
    # exclusive prefix count is an innermost-dim scan (a scan over the
    # outer dim of (G, T*k, E) takes tens of ms a layer on the card)
    flat = F.one_hot(expert_idx.reshape(g, t * k), cfg.n_experts).transpose(1, 2).contiguous()
    before = torch.cumsum(flat, dim=2) - flat
    if data is not None:
        before = before + data.sum_below(flat.sum(dim=2, keepdim=True))
    pos = before.gather(1, expert_idx.reshape(g, 1, t * k)).reshape(g, t, k)
    if tp is not None:
        gate_vals = tp.copy_to(gate_vals)
    return logits, probs, gate_vals, expert_idx, pos, pos < capacity


def _dispatch_compute_combine(cfg: MoEConfig, params, tokens, capacity: int, tp=None,
                              data=None):
    """The capacity MoE on token groups (G, T, d), each group with its own
    queues.  Returns (y (G, T, d), logits, probs, experts).  With ``tp``
    the rank's experts (or its share of every expert's hidden units) alone:
    y is the rank's partial sum.  ``data``: see the module docstring."""
    g, t, d = tokens.shape
    k, e = cfg.top_k, params["w_gate"].shape[0]
    logits, probs, gate_vals, expert_idx, pos, keep = _route(cfg, params["router"], tokens,
                                                             capacity, tp, data)
    e_flat = expert_idx.reshape(g, t * k)
    if e != cfg.n_experts:
        # the rank's experts [e0, e0 + e); entries routed elsewhere go to
        # the trash slot
        e0 = tp.index * e
        keep = keep & (expert_idx >= e0) & (expert_idx < e0 + e)
        e_flat = (e_flat - e0).clamp(0, e - 1)
    if tp is not None:
        tokens = tp.copy_to(tokens)
    pos_flat = torch.where(keep, pos, capacity).reshape(g, t * k)
    g_flat = torch.arange(g, device=tokens.device)[:, None].expand(g, t * k)
    with torch.profiler.record_function("repro/moe_dispatch"):
        expert_in = tokens.new_zeros((g, e, capacity + 1, d))
        expert_in.index_put_((g_flat, e_flat, pos_flat), tokens.repeat_interleave(k, dim=1))
        # (E, G*C, d): every group's slots of an expert in one GEMM
        expert_in = expert_in[:, :, :capacity].transpose(0, 1).reshape(e, g * capacity, d)
    dt = expert_in.dtype
    gate = torch.bmm(expert_in, params["w_gate"].to(dt))
    up = torch.bmm(expert_in, params["w_up"].to(dt))
    expert_out = torch.bmm(_act(cfg.activation, gate) * up, params["w_down"].to(dt))
    with torch.profiler.record_function("repro/moe_combine"):
        expert_out = expert_out.reshape(e, g, capacity, d)
        gathered = expert_out[e_flat, g_flat, torch.clamp(pos_flat, max=capacity - 1)]
        weight = (keep * gate_vals).reshape(g, t * k, 1).to(gathered.dtype)
        y = (gathered * weight).reshape(g, t, k, d).sum(dim=2)
    return y, logits, probs, expert_idx


def _expert_parallel(cfg: MoEConfig, params, tp):
    """``tp`` where the rank holds a shard of the experts (of their count or
    of their hidden units), else None: the experts run whole."""
    whole = (cfg.n_experts, cfg.d_model, cfg.d_ff)
    return tp if tp is not None and tuple(params["w_gate"].shape) != whole else None


def _queues(cfg: MoEConfig, n_tok: int, data=None):
    """The token groups and the capacity of ``n_tok`` tokens, a data rank's
    part of a batch split over ``data``'s ranks where it is given (the
    capacity then the whole batch's, in one group)."""
    if data is None:
        return _groups_and_capacity(cfg, n_tok)
    groups, capacity = _groups_and_capacity(cfg, n_tok * data.world)
    if groups != 1:
        raise NotImplementedError(
            "a 'grouped' MoE dispatch over a batch split on data ranks is not carried over")
    return groups, capacity


def moe_forward(cfg: MoEConfig, params, x: torch.Tensor, return_aux: bool = False, tp=None,
                data=None):
    """x: (B, S, d).  Returns ``(y, aux)``: the router's z-loss plus the
    Switch load-balance loss in fp32 with ``return_aux``, else None.
    ``tp``: a tensor-parallel node; ``data``: the data ranks that split the
    batch, and with ``return_aux`` ``aux`` is this rank's share of the
    whole batch's losses (see the module docstring)."""
    b, s, d = x.shape
    n_tok = b * s
    groups, capacity = _queues(cfg, n_tok, data)
    ep = _expert_parallel(cfg, params, tp)
    y, logits, probs, expert_idx = _dispatch_compute_combine(
        cfg, params, x.reshape(groups, n_tok // groups, d), capacity, ep, data)
    y = y.reshape(b, s, d)
    if ep is not None:
        y = ep.reduce_from(y)
    if cfg.n_shared_experts:
        shared = MLPConfig(cfg.d_model, cfg.d_ff * cfg.n_shared_experts, cfg.activation)
        y = y + mlp_forward(shared, params["shared"], x, tp=tp)
    if cfg.dense_residual:
        dense = MLPConfig(cfg.d_model, cfg.dense_d_ff or cfg.d_ff, cfg.activation)
        y = y + mlp_forward(dense, params["dense"], x, tp=tp)
    if not return_aux:
        return y, None
    z = torch.logsumexp(logits, dim=-1)
    counts = torch.bincount(expert_idx.reshape(-1), minlength=cfg.n_experts).float()
    # the groups are equal in size, so the mean of the group means is the
    # mean over the tokens; under ``data`` this rank's share of the whole
    # batch's means, and the whole batch's expert fractions
    n_all = n_tok * (1 if data is None else data.world)
    if data is not None:
        counts = data.all_reduce(counts)
    z_loss = cfg.router_z_loss * (z * z).sum() / n_all
    frac_tokens = counts / n_all
    frac_probs = probs.reshape(n_tok, cfg.n_experts).sum(dim=0) / n_all
    lb_loss = cfg.load_balance_loss * cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    return y, z_loss + lb_loss


def moe_routing(cfg: MoEConfig, params, x: torch.Tensor, tp=None, data=None):
    """The experts each token of x (B, S, d) goes to and whether each
    entry is kept, as ``moe_forward`` routes them: ``(experts, keep)``, both
    (B*S, k), in token order (with ``tp``, every rank the whole routing)."""
    b, s, d = x.shape
    groups, capacity = _queues(cfg, b * s, data)
    *_, expert_idx, _, keep = _route(cfg, params["router"],
                                     x.reshape(groups, b * s // groups, d), capacity,
                                     _expert_parallel(cfg, params, tp), data)
    return expert_idx.reshape(b * s, cfg.top_k), keep.reshape(b * s, cfg.top_k)
