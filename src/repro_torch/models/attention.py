"""GQA attention: the full-sequence (training / prefill) path and the decode
path against a ring-buffer KV cache.

Counterpart of ``repro.models.attention``: grouped-query attention, causal
or bidirectional masks, sliding windows (Gemma-2's local layers, with a
window-long ring buffer at decode), score soft-capping, RoPE and Qwen2-VL's
M-RoPE (positions (3, B, S); the masks read the temporal stream).
``attn_impl`` keeps the reference's three values: ``"xla"`` is the plain
full-softmax ``_sdpa``, ``"blockwise"`` the plain online-softmax twin, and
``"pallas"`` the hand-written flash-attention kernel behind
``api.call("flash_attention", ...)`` (CUDA C++ on the card; on CPU tensors
its plain version).  The kernel runs only where ``causal`` is set, as in
the reference: a bidirectional encoder (HuBERT) runs ``_sdpa`` under every
``attn_impl``.  The kernel is causal by index, while the plain paths mask
by position: under M-RoPE every vision token has temporal position 0, so
there the plain paths let the vision block see itself both ways and the
kernel does not (the reference's paths differ in the same way).

Under tensor parallelism (``tp``, a model group) a rank computes its H / M
query heads and the KV heads they read, in the training forward, the
prefill and the decode step; the prefill's cache and the decode step's
ring buffer are the rank's as ``cache_specs`` lays them out: its K / M KV
heads, or, where K does not divide by M, every KV head (each rank
projects and writes all of them and attends with its own).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .common import Initializer, apply_mrope, apply_rope, rms_norm

__all__ = ["AttentionConfig", "init_attention", "attention_forward", "init_kv_cache",
           "attention_decode"]

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    sliding_window: Optional[int] = None       # None = full attention
    attn_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    use_bias: bool = False
    qk_norm: bool = False
    attn_impl: str = "xla"                      # 'xla' | 'blockwise' | 'pallas'

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def init_attention(cfg: AttentionConfig, ini: Initializer):
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": ini.param((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ini.param((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ini.param((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ini.param((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        p["bq"] = ini.param((h, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = ini.param((k, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = ini.param((k, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = ini.param((hd,), ("head_dim",), init="ones")
        p["k_norm"] = ini.param((hd,), ("head_dim",), init="ones")
    return p


def _project_qkv(cfg: AttentionConfig, params, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if cfg.use_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(cfg: AttentionConfig, q_pos, kv_pos):
    """(B, Sq, Skv) bool: which keys each query sees, by position."""
    delta = q_pos[:, :, None] - kv_pos[:, None, :]
    mask = torch.ones(delta.shape, dtype=torch.bool, device=delta.device)
    if cfg.causal:
        mask &= delta >= 0
    if cfg.sliding_window is not None:
        mask &= delta.abs() < cfg.sliding_window
    return mask


def _sdpa(cfg: AttentionConfig, q, k, v, q_pos, kv_pos, kv_mask=None):
    """Plain scaled-dot-product attention with GQA + window + softcap.

    q: (B, Sq, H, hd); k/v: (B, Skv, K, hd); *_pos: (B, Sq)/(B, Skv).
    """
    b, sq, h, hd = q.shape
    kgroups = cfg.n_kv_heads
    qg = q.reshape(b, sq, kgroups, h // kgroups, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    scores = scores / float(torch.tensor(float(hd)).sqrt())
    if cfg.attn_softcap is not None:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    mask = _mask(cfg, q_pos, kv_pos)
    if kv_mask is not None:
        mask &= kv_mask[:, None, :]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _blockwise_sdpa(cfg: AttentionConfig, q, k, v, q_pos, kv_pos, block: int = 512):
    """Online-softmax attention over KV blocks in plain PyTorch: the
    (Sq, Skv) score matrix is never materialized (the reference's
    ``lax.scan`` becomes a loop over blocks)."""
    b, sq, h, hd = q.shape
    kgroups = cfg.n_kv_heads
    qpk = h // kgroups
    skv = k.shape[1]
    block = min(block, skv)
    if skv % block:
        raise ValueError(f"blockwise attention: {skv} keys in blocks of {block}")
    qg = q.reshape(b, sq, kgroups, qpk, hd).float()
    scale = 1.0 / (hd ** 0.5)
    acc = torch.zeros((b, kgroups, qpk, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, kgroups, qpk, sq), NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((b, kgroups, qpk, sq), dtype=torch.float32, device=q.device)
    for start in range(0, skv, block):
        sl = slice(start, start + block)
        s = torch.einsum("bskgh,btkh->bkgst", qg, k[:, sl].float()) * scale
        if cfg.attn_softcap is not None:
            s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
        s = torch.where(_mask(cfg, q_pos, kv_pos[:, sl])[:, None, None], s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        lsum = lsum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkh->bkgsh", p, v[:, sl].float())
        m = m_cur
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def _kv_take(cfg: AttentionConfig, h_loc: int, index: int, device):
    """The KV heads that a tensor-parallel rank's ``h_loc`` query heads
    (heads ``index * h_loc`` on) read out of all K: their count, and a
    function that takes them along a dim (a slice where the groups line up,
    each head its own KV head otherwise)."""
    qpk, h0 = cfg.q_per_kv, index * h_loc
    if h_loc % qpk == 0 or qpk % h_loc == 0:
        lo, k_loc = h0 // qpk, max(h_loc // qpk, 1)
        return k_loc, lambda w, dim: w.narrow(dim, lo, k_loc)
    idx = torch.tensor([(h0 + i) // qpk for i in range(h_loc)], device=device)
    return h_loc, lambda w, dim: w.index_select(dim, idx)


def _head_shard(cfg: AttentionConfig, params, x: torch.Tensor, tp, kv_whole: bool = False):
    """A tensor-parallel rank's attention: its query heads (``wq`` holds
    H / M of them) and the KV heads they read.  KV heads sharded with the
    query heads are used as they are; where they fell back to replicated,
    the rank slices the ones its heads use (:func:`_kv_take`), through
    ``tp.copy_to`` so that the replicated leaf's gradient is summed over the
    ranks, as the QK norms' are.  With ``kv_whole`` (a decode cache, which
    holds every KV head where they are replicated) the KV projections stay
    whole, and the returned ``take`` picks the rank's KV heads out of the
    projected keys and values instead (None where the KV heads are the
    rank's own).  Returns the rank's config, parameters and input (identity
    forward, gradient all-reduced backward), and ``take``."""
    h_loc = params["wq"].shape[1]
    k_loc = params["wk"].shape[1]
    p = dict(params)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = tp.copy_to(p[name])
    take = None
    if k_loc == cfg.n_kv_heads:            # KV heads replicated: slice them
        k_loc, take = _kv_take(cfg, h_loc, tp.index, x.device)
        if not kv_whole:
            for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
                if name in p:
                    p[name] = take(tp.copy_to(p[name]), dim)
            take = None
    local = dataclasses.replace(cfg, n_heads=h_loc, n_kv_heads=k_loc)
    return local, p, tp.copy_to(x), take


def attention_forward(cfg: AttentionConfig, params, x: torch.Tensor,
                      positions: torch.Tensor, return_cache: bool = False, tp=None):
    """Full-sequence (training / prefill) attention.  x: (B, S, d);
    positions (B, S), or (3, B, S) under M-RoPE.

    ``tp`` (a model group) runs the rank's heads of a tensor-parallel node
    (:func:`_head_shard`); ``wo``'s partial sums are all-reduced in fp32.
    Where the heads fell back to replicated (``wq`` holds all of them) the
    layer runs whole, with no collective.  With ``return_cache`` the cache
    is the rank's as ``launch/sharding.py``'s ``cache_specs`` lays it out:
    the rank's KV heads, or every KV head where they are replicated."""
    sharded = tp is not None and params["wq"].shape[1] != cfg.n_heads
    take = None
    if sharded:
        cfg, params, x, take = _head_shard(cfg, params, x, tp, kv_whole=return_cache)
    q, k, v = _project_qkv(cfg, params, x, positions)
    cache_k, cache_v = k, v
    if take is not None:
        k, v = take(k, 2).contiguous(), take(v, 2).contiguous()
    pos1 = positions[0] if cfg.mrope_sections is not None else positions
    if cfg.attn_impl == "pallas" and cfg.causal:
        from ..kernels import api as kernel_api

        out = kernel_api.call(
            "flash_attention", q, k, v,
            causal=True, sliding_window=cfg.sliding_window, softcap=cfg.attn_softcap,
        )
    elif cfg.attn_impl == "blockwise":
        out = _blockwise_sdpa(cfg, q, k, v, pos1, pos1)
    else:
        out = _sdpa(cfg, q, k, v, pos1, pos1)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(out.dtype))
    if sharded:
        y = tp.reduce_from(y)
    if return_cache:
        return y, {"k": cache_k, "v": cache_v, "pos": pos1}
    return y


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------
def init_kv_cache(cfg: AttentionConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None):
    """Ring-buffer KV cache; for sliding-window layers only ``window`` long."""
    size = max_len if cfg.sliding_window is None else min(max_len, cfg.sliding_window)
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32, device=device),  # -1 = empty
    }


def attention_decode(cfg: AttentionConfig, params, x: torch.Tensor,
                     position: torch.Tensor, cache, tp=None):
    """Single-token decode against the ring-buffer cache.  x (B, 1, d),
    position (B,) int32.  Returns ``(y, new_cache)``; the input cache is
    not modified.  Under M-RoPE the position is the same on all three
    streams (a text token).

    ``tp`` (a model group) runs the rank's query heads (:func:`_head_shard`)
    against its cache shard, laid out by ``cache_specs``: the rank's KV
    heads, whose new key and value it writes; or, where the KV heads are
    replicated, all of them, every one written (each rank keeps the whole
    cache) and the ones its heads read attended.  ``wo``'s partial sums are
    all-reduced in fp32."""
    sharded = tp is not None and params["wq"].shape[1] != cfg.n_heads
    take = None
    if sharded:
        cfg, params, x, take = _head_shard(cfg, params, x, tp, kv_whole=True)
    rope_pos = position[:, None]
    if cfg.mrope_sections is not None:
        rope_pos = rope_pos[None].expand(3, x.shape[0], 1)
    q, k_new, v_new = _project_qkv(cfg, params, x, rope_pos)
    size = cache["k"].shape[1]
    slot = (position % size).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    k = cache["k"].index_put((bidx, slot), k_new[:, 0].to(cache["k"].dtype))
    v = cache["v"].index_put((bidx, slot), v_new[:, 0].to(cache["v"].dtype))
    pos = cache["pos"].index_put((bidx, slot), position.to(torch.int32))
    k_att, v_att = (k, v) if take is None else (take(k, 2), take(v, 2))
    out = _sdpa(cfg, q, k_att, v_att, position[:, None], pos, kv_mask=pos >= 0)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(out.dtype))
    if sharded:
        y = tp.reduce_from(y)
    return y, {"k": k, "v": v, "pos": pos}
