"""Plain PyTorch versions of the RWKV-6 wkv recurrence: the kernel's two
yardsticks.

``wkv_ref`` is the counterpart of ``repro.kernels.wkv_chunk.ref.wkv_ref``:
the exact per-token recurrence, the op's plain version and its CPU path.

``wkv_chunked_ref`` is the chunked form of ``repro.models.rwkv._chunked_wkv``
(the model's plain chunked path), which the reference's Pallas kernel also
computes: per chunk of L tokens, decay-weighted r and k with the decay
exponents clamped at +-25, so where a chunk's log-decay sums past -25 it
departs from the exact recurrence.  The hand-written kernel computes this
form; it agrees with ``wkv_ref`` only inside that envelope.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["CLAMP", "wkv_ref", "wkv_chunked_ref"]

CLAMP = 25.0


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
            s0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token recurrence ``y_t = r_t S_{t-1}``, ``S_t = diag(exp(w_t))
    S_{t-1} + k_t v_t^T``.

    r/k/v/logw: (B, S, H, P), logw < 0.  Returns (y (B, S, H, P) fp32,
    s_final (B, H, P, P) fp32).  y excludes the current-token bonus term
    (the model adds it outside, it is diagonal in t).
    """
    b, s, h, p = r.shape
    r, k, v, logw = (t.float() for t in (r, k, v, logw))
    state = (torch.zeros((b, h, p, p), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=r.device)
    for t in range(s):
        y[:, t] = torch.einsum("bhp,bhpq->bhq", r[:, t], state)
        state = torch.exp(logw[:, t])[..., None] * state + k[:, t, ..., None] * v[:, t, :, None, :]
    return y, state


def wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                    chunk: int, s0: Optional[torch.Tensor] = None,
                    bf16_operands: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The clamped chunked recurrence, in the reference's order.

    Per chunk: ``cum`` the inclusive cumsum of logw, ``cex = cum - w``,
    ``r~ = r exp(max(cex, -25))``, ``k~ = k exp(min(-cum, 25))``,
    ``y = tril(r~ k~^T, -1) v + r~ S`` and ``S <- exp(cum_L) S +
    (k exp(max(cum_L - cum, -25)))^T v``.  The in-chunk products of every
    chunk run at once; only the state carry loops over chunks.
    ``bf16_operands`` rounds each product's operands to bf16 and sums in
    fp32 (the reference's ``chunk_bf16``).  Returns (y (B, S, H, P) fp32,
    s_final (B, H, P, P) fp32).
    """
    b, s, h, p = r.shape
    lc = min(chunk, s)
    if lc < 1 or s % lc:
        raise ValueError(f"wkv: sequence length {s} is not a multiple of chunk {chunk}")
    n = s // lc
    r, k, v, w = (t.float().reshape(b, n, lc, h, p) for t in (r, k, v, logw))
    mm = (lambda t: t.to(torch.bfloat16).float()) if bf16_operands else (lambda t: t)
    cum = torch.cumsum(w, dim=2)                     # inclusive, <= 0
    cex = cum - w                                    # exclusive
    total = cum[:, :, -1]                            # (B, n, H, P)
    r_t = r * torch.exp(torch.clamp(cex, min=-CLAMP))
    k_t = k * torch.exp(torch.clamp(-cum, max=CLAMP))
    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=r.device), diagonal=-1)
    scores = torch.einsum("bnlhp,bnmhp->bnhlm", mm(r_t), mm(k_t))
    scores = torch.where(mask, scores, torch.zeros((), device=r.device))
    y = torch.einsum("bnhlm,bnmhp->bnlhp", mm(scores), mm(v))
    k_s = k * torch.exp(torch.clamp(total[:, :, None] - cum, min=-CLAMP))
    ds = torch.einsum("bnlhp,bnlhq->bnhpq", mm(k_s), mm(v))
    decay = torch.exp(total)[..., None]              # (B, n, H, P, 1)
    state = (torch.zeros((b, h, p, p), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    entering = []                                    # the state each chunk reads
    for c in range(n):
        entering.append(state)
        state = decay[:, c] * state + ds[:, c]
    y = y + torch.einsum("bnlhp,bnhpq->bnlhq", mm(r_t), mm(torch.stack(entering, dim=1)))
    return y.reshape(b, s, h, p), state
