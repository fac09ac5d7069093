"""Mamba-2 (SSD) block: the chunked selective state-space scan and the
decode recurrence.

Counterpart of ``repro.models.mamba``.  The sequence path is the chunked
state-space-duality algorithm: within a chunk the output is a masked,
decay-weighted contraction (an attention-like product), and across chunks
a small recurrent state (B, H, P, N) is carried -- the reference's
``lax.scan`` over chunks is a Python loop here, over the state recurrence
alone: the terms that do not need the carried state are computed for all
chunks at once (one Python op a chunk, not twenty).  Decode advances the
same recurrence one token at a time with a rolling conv window.  The reference computes the scan in plain jnp, outside any
Pallas kernel; so does the port, in PyTorch (the chunk products are
cuBLAS batched GEMMs on the card).  Each prefill's scan runs inside a
``repro/ssd_scan`` profiler range, so a trace can attribute its kernels.

``mamba_forward`` takes ``tp``, a model group (``launch/mesh.py``'s
``ModelGroup``), for a node spread tensor-parallel over M ranks as the 'tp'
profile lays it out.  A rank computes its own H / M heads: ``a_log``,
``d_skip`` and ``dt_bias`` are its heads, ``norm`` and ``w_out`` its
channels of ``d_inner``.  The fused input projection ``w_in`` (columns
``[z | x | B | C | dt]``) and ``conv_w`` (columns ``[x | B | C]``) shard
their columns in M contiguous blocks, which do not line up with the heads
(Zamba2-7B: rank 0's ``w_in`` columns are all of ``z`` and 120 of ``x``).
So the rank computes its block of the projection's columns
(column-parallel, from ``copy_to`` of the input) and all-gathers that
activation (``gather_sum``: its backward reduce-scatters the gradient's
sum over the ranks), then takes the ``z``, ``x`` and ``dt`` columns of its
heads and ``B`` and ``C`` whole: those two are shared by every head,
computed on every rank, and each rank's heads add their part of their
gradient, which the reduce-scatter sums.  ``conv_w`` (a few KB) is gathered
the same way.  Gathering the projection's output rather than ``w_in``
itself moves ``tokens x 2 d_inner`` values a forward instead of ``d_model x
2 d_inner``: less for batches under about ``2 d_model`` tokens a node in
bf16 (Zamba2-7B's 2,048-token node batch: 30 MB a rank against 104 MB), and
no projection is computed twice.  The gated norm normalises over the whole
``d_inner`` (``sharded_rms_norm``), and ``w_out`` is row-parallel, its
partial sums all-reduced (``reduce_from``).  The SSD scan runs on the
rank's heads unchanged.  Where the heads fell back to replicated, the block
runs whole on every rank, its sharded leaves gathered first.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import Initializer, rms_norm, sharded_rms_norm

__all__ = ["MambaConfig", "init_mamba", "mamba_forward", "init_mamba_cache", "mamba_decode"]


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int                  # typically 2 * d_model
    state_dim: int = 64           # N
    head_dim: int = 64            # P
    conv_width: int = 4
    chunk: int = 128

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.head_dim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of "
                             f"head_dim {self.head_dim}")
        return self.d_inner // self.head_dim


def init_mamba(cfg: MambaConfig, ini: Initializer):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.state_dim, cfg.n_heads
    return {
        # fused input projection -> [z, x, B, C, dt]
        "w_in": ini.param((d, 2 * di + 2 * n + h), ("embed", "ssm_in")),
        "conv_w": ini.param((cfg.conv_width, di + 2 * n), (None, "ssm_in"), scale=0.5),
        "a_log": ini.param((h,), ("heads",), init="zeros"),
        "d_skip": ini.param((h,), ("heads",), init="ones"),
        "dt_bias": ini.param((h,), ("heads",), init="zeros"),
        "norm": ini.param((di,), ("ffn",), init="ones"),
        "w_out": ini.param((di, d), ("ffn", "embed")),
    }


def _project(cfg: MambaConfig, params, u):
    """u: (B, S, d) -> z (B, S, di), xbc (B, S, di+2N), dt (B, S, H) raw."""
    proj = torch.einsum("bsd,de->bse", u, params["w_in"].to(u.dtype))
    di, n = cfg.d_inner, cfg.state_dim
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _conv(cfg: MambaConfig, xbc, conv_w, conv_state=None):
    """Causal depthwise conv over time. xbc: (B, S, C).  Returns (silu(y),
    the last ``conv_width - 1`` inputs as the new state)."""
    w = conv_w.to(xbc.dtype)   # (W, C)
    kw = cfg.conv_width
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], kw - 1, xbc.shape[-1]))
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, kw):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(kw - 1):] if kw > 1 else pad
    return F.silu(y), new_state


def _split_xbc(cfg: MambaConfig, xbc):
    di, n = cfg.d_inner, cfg.state_dim
    return xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]


def _ssd_chunked(cfg: MambaConfig, a, xh, b_in, c_in, dt, h0=None):
    """Chunked SSD scan.

    a: (H,) negative per-head decay rate.
    xh: (B, S, H, P); b_in/c_in: (B, S, N); dt: (B, S, H) post-softplus.
    Returns y (B, S, H, P) in xh's dtype, final state (B, H, P, N) fp32.

    Each chunk's terms are the reference's ``chunk_body``; those that do
    not need the carried state (the intra-chunk output and each chunk's
    state increment) are computed for every chunk at once, in a (B, C, H,
    ...) layout, and only the state recurrence runs as a loop over chunks.
    """
    bsz, s, nh, p = xh.shape
    n = b_in.shape[-1]
    lc = min(cfg.chunk, s)
    if s % lc:
        raise ValueError(f"SSD scan: {s} tokens in chunks of {lc}")
    nc = s // lc
    above = ~torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=xh.device))
    x = xh.reshape(bsz, nc, lc, nh, p).float().transpose(2, 3)      # (B, C, H, lc, P)
    bk = b_in.reshape(bsz, nc, lc, n).float()                       # (B, C, lc, N)
    ck = c_in.reshape(bsz, nc, lc, n).float()
    dtk = dt.reshape(bsz, nc, lc, nh).float().transpose(2, 3)       # (B, C, H, lc)
    cum = torch.cumsum(dtk * a[:, None], dim=-1)
    total = cum[..., -1]                                            # (B, C, H)
    # decay matrix L[t, j] = exp(cum_t - cum_j), j <= t; scores cb * L * dt_j
    diff = cum[..., :, None] - cum[..., None, :]
    cb = (ck @ bk.transpose(-1, -2))[:, :, None]
    if diff.requires_grad:   # autograd keeps each step's input
        # masked before the exp: above the diagonal exp(cum_t - cum_j)
        # overflows to inf on long chunks (Zamba2-7B's 128 tokens), and a
        # mask applied after it backpropagates 0 * inf = nan (the
        # reference's jnp.where does); the forward's bits are the same
        scores = torch.exp(diff.masked_fill(above, -torch.inf)) * cb * dtk[..., None, :]
    else:
        scores = torch.exp_(diff)
        scores.masked_fill_(above, 0.0).mul_(cb).mul_(dtk[..., None, :])
    y = scores @ x                                                  # intra-chunk
    del scores, cb
    w_j = torch.exp(total[..., None] - cum) * dtk                   # (B, C, H, lc)
    dh = (x * w_j[..., None]).transpose(-1, -2) @ bk[:, :, None]    # (B, C, H, P, N)
    decay = torch.exp(total)[..., None, None]
    h = (torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    h_in = []
    for c in range(nc):    # the reference's lax.scan over chunks
        h_in.append(h)
        h = decay[:, c] * h + dh[:, c]
    h_in = torch.stack(h_in, dim=1)                                 # (B, C, H, P, N)
    y += (ck[:, :, None] @ h_in.transpose(-1, -2)) * torch.exp(cum)[..., None]
    return y.transpose(2, 3).reshape(bsz, s, nh, p).to(xh.dtype), h


def _full_shapes(cfg: MambaConfig) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.state_dim, cfg.n_heads
    return {"w_in": (d, 2 * di + 2 * n + h), "conv_w": (cfg.conv_width, di + 2 * n),
            "a_log": (h,), "d_skip": (h,), "dt_bias": (h,), "norm": (di,), "w_out": (di, d)}


def _sharded_dim(p: torch.Tensor, full) -> int:
    """The dim along which ``p`` holds a shard of a leaf of shape ``full``
    (-1: it holds the whole leaf)."""
    return next((i for i, (a, b) in enumerate(zip(p.shape, full)) if a != b), -1)


def _forward_tp(cfg: MambaConfig, params, u: torch.Tensor, tp) -> torch.Tensor:
    """The rank's heads of a tensor-parallel Mamba-2 block (see the module
    docstring).  u: (B, S, d_model), replicated; returns the block's
    output, all-reduced."""
    full = _full_shapes(cfg)
    di, n, p = cfg.d_inner, cfg.state_dim, cfg.head_dim
    h_loc = params["a_log"].shape[0]
    width, c0, h0 = h_loc * p, tp.index * h_loc * p, tp.index * h_loc
    if _sharded_dim(params["w_in"], full["w_in"]) == 1:
        proj = torch.einsum("bsd,de->bse", tp.copy_to(u), params["w_in"].to(u.dtype))
        proj = tp.gather_sum(proj, 2)
    else:
        proj = tp.copy_to(torch.einsum("bsd,de->bse", u, params["w_in"].to(u.dtype)))
    conv_w = params["conv_w"]
    conv_w = (tp.gather_sum(conv_w, 1) if _sharded_dim(conv_w, full["conv_w"]) == 1
              else tp.copy_to(conv_w))
    z = proj[..., c0:c0 + width]
    bc = slice(2 * di, 2 * di + 2 * n)
    xbc = torch.cat([proj[..., di + c0:di + c0 + width], proj[..., bc]], dim=-1)
    conv_w = torch.cat([conv_w[:, c0:c0 + width], conv_w[:, di:di + 2 * n]], dim=-1)
    dt_raw = proj[..., 2 * di + 2 * n + h0:2 * di + 2 * n + h0 + h_loc]
    xbc, _ = _conv(cfg, xbc, conv_w)
    x, b_in, c_in = xbc[..., :width], xbc[..., width:width + n], xbc[..., width + n:]
    bsz, s, _ = x.shape
    xh = x.reshape(bsz, s, h_loc, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    with torch.profiler.record_function("repro/ssd_scan"):
        y, _ = _ssd_chunked(cfg, a, xh, b_in, c_in, dt)
    y = y + xh * params["d_skip"].to(y.dtype)[None, None, :, None]
    y = sharded_rms_norm(y.reshape(bsz, s, width) * F.silu(z), params["norm"], tp, di)
    return tp.reduce_from(torch.einsum("bse,ed->bsd", y, params["w_out"].to(y.dtype)))


def mamba_forward(cfg: MambaConfig, params, u: torch.Tensor, return_cache: bool = False,
                  tp=None):
    """Full-sequence forward. u: (B, S, d_model).  With ``return_cache``
    also the decode cache ``{"conv", "ssm"}`` the sequence leaves.  ``tp``
    (forward only): the rank's heads of a tensor-parallel node (see the
    module docstring)."""
    if tp is not None:
        full = _full_shapes(cfg)
        if params["a_log"].shape[0] != cfg.n_heads:
            return _forward_tp(cfg, params, u, tp)
        # heads replicated: the whole block on every rank, from whole leaves
        params = {k: v if _sharded_dim(v, full[k]) < 0 else
                  tp.gather_from(v, _sharded_dim(v, full[k])) for k, v in params.items()}
    z, xbc, dt_raw = _project(cfg, params, u)
    xbc, conv_state = _conv(cfg, xbc, params["conv_w"])
    x, b_in, c_in = _split_xbc(cfg, xbc)
    bsz, s, _ = x.shape
    xh = x.reshape(bsz, s, cfg.n_heads, cfg.head_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    with torch.profiler.record_function("repro/ssd_scan"):
        y, h_final = _ssd_chunked(cfg, a, xh, b_in, c_in, dt)
    y = y + xh * params["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, cfg.d_inner)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = torch.einsum("bse,ed->bsd", y, params["w_out"].to(y.dtype))
    if return_cache:
        return out, {"conv": conv_state, "ssm": h_final}
    return out


def init_mamba_cache(cfg: MambaConfig, batch: int, dtype=torch.bfloat16, device=None):
    """The rolling conv window in ``dtype`` and the SSM state in fp32."""
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.state_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.state_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(cfg: MambaConfig, params, u: torch.Tensor, cache):
    """One-token decode. u: (B, 1, d_model).  Returns ``(y, new_cache)``;
    the input cache is not modified."""
    z, xbc, dt_raw = _project(cfg, params, u)
    xbc, conv_state = _conv(cfg, xbc, params["conv_w"], conv_state=cache["conv"])
    x, b_in, c_in = _split_xbc(cfg, xbc)
    bsz = x.shape[0]
    xh = x.reshape(bsz, cfg.n_heads, cfg.head_dim).float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"].float())   # (B, H)
    a = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt * a)   # (B, H)
    dh = torch.einsum("bh,bn,bhp->bhpn", dt, b_in[:, 0].float(), xh)
    h_new = decay[..., None, None] * cache["ssm"] + dh
    y = torch.einsum("bn,bhpn->bhp", c_in[:, 0].float(), h_new)
    y = y + xh * params["d_skip"].float()[None, :, None]
    y = y.reshape(bsz, 1, cfg.d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = torch.einsum("bse,ed->bsd", y, params["w_out"].to(y.dtype))
    return out, {"conv": conv_state.to(cache["conv"].dtype), "ssm": h_new}
