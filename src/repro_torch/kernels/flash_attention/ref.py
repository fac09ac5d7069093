"""Plain PyTorch version of the flash-attention forward (GQA, causal,
sliding window, score soft-capping), in the model's (B, S, H, D) layout.

Counterpart of ``repro.kernels.flash_attention.ref.flash_attention_ref``:
the whole (Sq, Skv) score matrix in fp32, masked with -2e38 and put through
one softmax.  It is the CPU path, the yardstick the kernel is held to and
the function the op's backward differentiates.  Without grad the
elementwise steps run in place on the fresh score tensor, so a full
8192-token sequence fits the card twice over; when the scores require
grad the same steps run out of place, because autograd keeps their inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention_ref", "NEG_INF"]

NEG_INF = -2.0e38


def flash_attention_ref(
    q: torch.Tensor,          # (B, Sq, H, D)
    k: torch.Tensor,          # (B, Skv, K, D)
    v: torch.Tensor,          # (B, Skv, K, D)
    causal: bool = True,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if h % kh:
        raise ValueError(f"flash_attention: {h} query heads on {kh} kv heads")
    qg = q.reshape(b, sq, kh, h // kh, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scale = float(torch.tensor(float(d)).sqrt())
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if sliding_window is not None:
        mask &= (qpos - kpos) < sliding_window
    if scores.requires_grad:   # autograd keeps each step's input
        scores = scores / scale
        if softcap is not None:
            scores = torch.tanh(scores / softcap) * softcap
        scores = scores.masked_fill(~mask, NEG_INF)
    else:
        scores.div_(scale)
        if softcap is not None:
            scores.div_(softcap).tanh_().mul_(softcap)
        scores.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
