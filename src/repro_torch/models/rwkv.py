"""RWKV-6 (Finch) block: attention-free time-mix with data-dependent decay.

Counterpart of ``repro.models.rwkv``.  Time-mix recurrence per head (state
S: head_dim x head_dim):

    w_t = exp(-exp(w0 + lora_w(x~_t)))            # data-dependent decay
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T S_{t-1} + (r_t . (u . k_t)) v_t   # u = per-channel bonus

plus token-shift lerps on the inputs and a squared-ReLU channel-mix.  The
sequence path has the reference's three branches: the hand-written kernel
through ``api.call("wkv_chunk", ...)`` (``use_pallas``), the plain chunked
form (``chunk > 0``), and the per-token recurrence (``chunk == 0`` or a
length that is not a multiple of the chunk).  The chunked forms clamp the
decay exponents at +-25 (``kernels/wkv_chunk/ref.py``).  Decode is the O(1)
single-step recurrence.

``timemix_forward`` and ``chanmix_forward`` take ``tp``, a model group
(``launch/mesh.py``'s ``ModelGroup``), for a node spread tensor-parallel
over M ranks as the 'tp' profile lays it out (Megatron).  The time mix:
``w_r``, ``w_k``, ``w_v``, ``w_g`` and ``decay_lora_b`` are column-parallel
on ``heads_flat``, ``decay_base``, ``bonus_u`` and ``ln_x`` are the rank's
heads, and the rank runs the recurrence (the ``wkv_chunk`` kernel, or a
plain form) on its H / M heads; the input, the token-shift lerps' ``mix_*``
and ``decay_lora_a`` are replicated and enter through ``copy_to``, so that
their gradients are summed over the ranks; ``ln_x`` normalises over the
whole width (``sharded_rms_norm``) and ``w_o`` is row-parallel, its partial
sums all-reduced (``reduce_from``).  The channel mix: ``cw_k`` is
column-parallel on ``ffn``, ``cw_v`` row-parallel then ``reduce_from``;
``cw_r`` (``(embed, embed)``) is replicated and its gate runs whole on every
rank.  Each mix reads its layout off its shards' shapes: where its parallel
dim fell back to replicated it runs whole.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import api
from ..kernels.wkv_chunk.ref import wkv_chunked_ref, wkv_ref
from .common import Initializer, rms_norm, sharded_rms_norm

__all__ = ["RWKVConfig", "init_rwkv", "timemix_forward", "chanmix_forward",
           "init_rwkv_cache", "timemix_decode", "chanmix_decode"]


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    d_ff: int
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 0            # 0 = per-token recurrence; > 0 = chunked
    chunk_bf16: bool = False  # bf16 operands in the plain chunked form
    use_pallas: bool = False  # chunked wkv through the hand-written kernel

    @property
    def n_heads(self) -> int:
        if self.d_model % self.head_dim:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"head_dim {self.head_dim}")
        return self.d_model // self.head_dim


def init_rwkv(cfg: RWKVConfig, ini: Initializer):
    d, f = cfg.d_model, cfg.d_ff
    return {
        # time-mix
        "mix_r": ini.param((d,), ("embed",), init="zeros"),
        "mix_k": ini.param((d,), ("embed",), init="zeros"),
        "mix_v": ini.param((d,), ("embed",), init="zeros"),
        "mix_w": ini.param((d,), ("embed",), init="zeros"),
        "mix_g": ini.param((d,), ("embed",), init="zeros"),
        "w_r": ini.param((d, d), ("embed", "heads_flat")),
        "w_k": ini.param((d, d), ("embed", "heads_flat")),
        "w_v": ini.param((d, d), ("embed", "heads_flat")),
        "w_g": ini.param((d, d), ("embed", "heads_flat")),
        "w_o": ini.param((d, d), ("heads_flat", "embed")),
        "decay_base": ini.param((d,), ("heads_flat",), init="zeros"),
        "decay_lora_a": ini.param((d, cfg.decay_lora), ("embed", None)),
        "decay_lora_b": ini.param((cfg.decay_lora, d), (None, "heads_flat"), scale=0.1),
        "bonus_u": ini.param((d,), ("heads_flat",), init="zeros"),
        "ln_x": ini.param((d,), ("heads_flat",), init="ones"),
        # channel-mix
        "cmix_k": ini.param((d,), ("embed",), init="zeros"),
        "cmix_r": ini.param((d,), ("embed",), init="zeros"),
        "cw_k": ini.param((d, f), ("embed", "ffn")),
        "cw_v": ini.param((f, d), ("ffn", "embed")),
        "cw_r": ini.param((d, d), ("embed", "embed")),
    }


def _shift(x, prev=None):
    """Token shift: x_{t-1} with x_{-1} = prev (or zeros)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * torch.sigmoid(mu.to(x.dtype))


def _timemix_inputs(cfg, params, x, shifted):
    r_in = _lerp(x, shifted, params["mix_r"])
    k_in = _lerp(x, shifted, params["mix_k"])
    v_in = _lerp(x, shifted, params["mix_v"])
    w_in = _lerp(x, shifted, params["mix_w"])
    g_in = _lerp(x, shifted, params["mix_g"])
    dt = x.dtype
    r = r_in @ params["w_r"].to(dt)
    k = k_in @ params["w_k"].to(dt)
    v = v_in @ params["w_v"].to(dt)
    g = F.silu(g_in @ params["w_g"].to(dt))
    lora = torch.tanh(w_in @ params["decay_lora_a"].to(dt)) @ params["decay_lora_b"].to(dt)
    logw = -torch.exp(params["decay_base"].float() + lora.float())   # log decay < 0
    return r, k, v, g, logw


def _heads(cfg, t):
    """(B, S, H * P) -> (B, S, H, P): the head count is read off the
    tensor (a tensor-parallel rank holds H / M heads)."""
    b, s, width = t.shape
    return t.reshape(b, s, width // cfg.head_dim, cfg.head_dim)


def _chunked_wkv(cfg: RWKVConfig, rh, kh, vh, wh, s0):
    """The plain chunked recurrence (the kernel's twin): rh/kh/vh
    (B, S, H, P), wh (B, S, H, P) log-decay, s0 (B, H, P, P) fp32.  Returns
    (y (B, S, H, P) fp32, s_final)."""
    return wkv_chunked_ref(rh, kh, vh, wh, cfg.chunk, s0, bf16_operands=cfg.chunk_bf16)


def _bonus(rh, kh, vh, u):
    """The current-token term (r_t . (u . k_t)) v_t, fp32."""
    rk = (rh.float() * (u * kh.float())).sum(dim=-1, keepdim=True)
    return rk * vh.float()


def _timemix_shard(cfg: RWKVConfig, params, x, tp):
    """A tensor-parallel rank's time mix: its input and parameters, the
    replicated ones through ``tp.copy_to`` (identity forward, gradient
    summed over the ranks backward)."""
    width = params["w_r"].shape[-1]
    if width % cfg.head_dim:
        raise NotImplementedError(
            f"a tensor-parallel RWKV time mix needs whole heads a rank: {width} channels "
            f"of heads of {cfg.head_dim}")
    p = dict(params)
    for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "decay_lora_a"):
        p[name] = tp.copy_to(p[name])
    return p, tp.copy_to(x)


def timemix_forward(cfg: RWKVConfig, params, x, return_cache: bool = False, tp=None):
    """Full-sequence time-mix.  x: (B, S, d), already normed.  ``tp``: the
    rank's heads of a tensor-parallel node (see the module docstring)."""
    b, s, d = x.shape
    sharded = tp is not None and params["w_r"].shape[-1] != cfg.d_model
    if sharded:
        params, x = _timemix_shard(cfg, params, x, tp)
    r, k, v, g, logw = _timemix_inputs(cfg, params, x, _shift(x))
    rh, kh, vh = _heads(cfg, r), _heads(cfg, k), _heads(cfg, v)
    wh = _heads(cfg, logw)
    h = rh.shape[2]
    u = params["bonus_u"].float().reshape(h, cfg.head_dim)
    if cfg.chunk and s % cfg.chunk == 0:
        if cfg.use_pallas:
            y, s_final = api.call("wkv_chunk", rh, kh, vh, wh, chunk=cfg.chunk)
        else:
            s0 = torch.zeros((b, h, cfg.head_dim, cfg.head_dim),
                             dtype=torch.float32, device=x.device)
            y, s_final = _chunked_wkv(cfg, rh, kh, vh, wh, s0)
    else:
        y, s_final = wkv_ref(rh, kh, vh, wh)
    y = (y + _bonus(rh, kh, vh, u)).reshape(b, s, h * cfg.head_dim).to(x.dtype)
    if sharded:
        y = sharded_rms_norm(y, params["ln_x"], tp, d) * g
    else:
        y = rms_norm(y, params["ln_x"]) * g
    out = y @ params["w_o"].to(y.dtype)
    if sharded:
        out = tp.reduce_from(out)
    if return_cache:
        return out, {"wkv": s_final, "shift_t": x[:, -1:]}
    return out


def chanmix_forward(cfg: RWKVConfig, params, x, return_cache: bool = False, tp=None):
    """Full-sequence channel-mix (squared ReLU).  x: (B, S, d), normed.
    ``tp``: the rank's hidden units of a tensor-parallel node."""
    shifted = _shift(x)
    sharded = tp is not None and params["cw_k"].shape[-1] != cfg.d_ff
    xk, sk, mix_k = x, shifted, params["cmix_k"]
    if sharded:
        xk, mix_k = tp.copy_to(x), tp.copy_to(mix_k)
        sk = _shift(xk)
    kc = _lerp(xk, sk, mix_k) @ params["cw_k"].to(x.dtype)
    kc = torch.square(torch.relu(kc))
    rc = torch.sigmoid(_lerp(x, shifted, params["cmix_r"]) @ params["cw_r"].to(x.dtype))
    kv = kc @ params["cw_v"].to(kc.dtype)
    if sharded:
        kv = tp.reduce_from(kv)
    out = rc * kv
    if return_cache:
        return out, {"shift_c": x[:, -1:]}
    return out


def init_rwkv_cache(cfg: RWKVConfig, batch: int, dtype=torch.bfloat16, device=None):
    """The recurrent state (fp32 whatever ``dtype``) and the two token
    shifts (in ``dtype``)."""
    return {
        "wkv": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                           dtype=torch.float32, device=device),
        "shift_t": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
    }


def timemix_decode(cfg: RWKVConfig, params, x, cache):
    """One-token time-mix.  x: (B, 1, d), normed."""
    b = x.shape[0]
    shifted = cache["shift_t"].to(x.dtype)
    r, k, v, g, logw = _timemix_inputs(cfg, params, x, shifted)
    rh, kh, vh = (_heads(cfg, t)[:, 0].float() for t in (r, k, v))
    wh = _heads(cfg, logw)[:, 0]
    u = params["bonus_u"].float().reshape(cfg.n_heads, cfg.head_dim)
    s_prev = cache["wkv"]
    y = torch.einsum("bhp,bhpq->bhq", rh, s_prev) + _bonus(rh, kh, vh, u)
    s_new = torch.exp(wh)[..., None] * s_prev + kh[..., None] * vh[..., None, :]
    y = y.reshape(b, 1, cfg.d_model).to(x.dtype)
    y = rms_norm(y, params["ln_x"]) * g
    out = y @ params["w_o"].to(y.dtype)
    return out, {"wkv": s_new, "shift_t": x.to(cache["shift_t"].dtype)}


def chanmix_decode(cfg: RWKVConfig, params, x, cache):
    shifted = cache["shift_c"].to(x.dtype)
    kc = _lerp(x, shifted, params["cmix_k"]) @ params["cw_k"].to(x.dtype)
    kc = torch.square(torch.relu(kc))
    rc = torch.sigmoid(_lerp(x, shifted, params["cmix_r"]) @ params["cw_r"].to(x.dtype))
    out = rc * (kc @ params["cw_v"].to(kc.dtype))
    return out, {"shift_c": x.to(cache["shift_c"].dtype)}
