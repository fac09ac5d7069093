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

``wkv_grouped_ref`` is the same clamped chunked form computed the way the
kernel computes it: chunks in groups, each group's state increment first,
then the carry across groups, then every group's outputs from its entering
state.  It mirrors the kernel's order of operations for the tests and
``chip_smoke.py``; the models never call it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["CLAMP", "wkv_ref", "wkv_chunked_ref", "wkv_grouped_ref"]

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


def wkv_grouped_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                    chunk: int, group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The clamped chunked recurrence in the kernel's three passes, with the
    state starting at zero.

    The chunks of each (b, h) are cut into groups of ``group`` consecutive
    chunks (the last group may be shorter).  Pass A folds each group's
    chunks into its increment ``U <- exp(total_c) (.) U + ds_c`` and decay
    product ``D <- D (.) exp(total_c)``; pass B carries ``S <- D_g (.) S +
    U_g`` across the groups from zero, keeping each group's entering state;
    pass C replays each group's chunks from its entering state as
    ``wkv_chunked_ref`` does.  Algebraically this is ``wkv_chunked_ref``;
    only the order in which the decay products meet the state differs.
    Returns (y (B, S, H, P) fp32, s_final (B, H, P, P) fp32).
    """
    b, s, h, p = r.shape
    lc = min(chunk, s)
    if lc < 1 or s % lc or group < 1:
        raise ValueError(f"wkv: sequence length {s}, chunk {chunk}, group {group}")
    n = s // lc
    ng = -(-n // group)
    # pad to whole groups with identity chunks (logw 0, k = v = 0): exp(0) is
    # 1 and their increment 0, so they change neither U nor D
    pad = (0, 0, 0, 0, 0, 0, 0, ng * group - n)
    r, k, v, w = (torch.nn.functional.pad(t.float().reshape(b, n, lc, h, p), pad)
                  .reshape(b, ng, group, lc, h, p) for t in (r, k, v, logw))
    cum = torch.cumsum(w, dim=3)
    total = cum[:, :, :, -1]                         # (B, ng, G, H, P)
    r_t = r * torch.exp(torch.clamp(cum - w, min=-CLAMP))
    k_t = k * torch.exp(torch.clamp(-cum, max=CLAMP))
    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=r.device), diagonal=-1)
    scores = torch.einsum("bgclhp,bgcmhp->bgchlm", r_t, k_t)
    scores = torch.where(mask, scores, torch.zeros((), device=r.device))
    intra = torch.einsum("bgchlm,bgcmhp->bgclhp", scores, v)
    k_s = k * torch.exp(torch.clamp(total[:, :, :, None] - cum, min=-CLAMP))
    ds = torch.einsum("bgclhp,bgclhq->bgchpq", k_s, v)
    decay = torch.exp(total)                         # (B, ng, G, H, P)
    # pass A: every group's increment and decay product
    u = torch.zeros((b, ng, h, p, p), dtype=torch.float32, device=r.device)
    d = torch.ones((b, ng, h, p), dtype=torch.float32, device=r.device)
    for c in range(group):
        u = decay[:, :, c, ..., None] * u + ds[:, :, c]
        d = d * decay[:, :, c]
    # pass B: the carry across groups; each group's entering state
    state = torch.zeros((b, h, p, p), dtype=torch.float32, device=r.device)
    entering = []
    for g in range(ng):
        entering.append(state)
        state = d[:, g, ..., None] * state + u[:, g]
    # pass C: each group's outputs from its entering state
    st = torch.stack(entering, dim=1)                # (B, ng, H, P, P)
    ys = []
    for c in range(group):
        ys.append(intra[:, :, c] + torch.einsum("bglhp,bghpq->bglhq", r_t[:, :, c], st))
        st = decay[:, :, c, ..., None] * st + ds[:, :, c]
    y = torch.stack(ys, dim=2).reshape(b, ng * group * lc, h, p)[:, :s]
    return y, state
