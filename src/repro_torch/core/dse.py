"""DSE-MVR and DSE-SGD, the paper's algorithms (Alg. 1 / Alg. 2), in PyTorch.

Counterpart of ``repro.core.dse``.  Written per node over dict trees of
tensors; in the Simulator every leaf carries a leading node axis and
``mix_fn`` is a dense ``W`` contraction.

  local step t (mod(t+1, tau) != 0):
      x_{t+1}   = x_t - gamma_t * v_t
      v_{t+1}   = g(x_{t+1}; xi) + (1 - alpha) * (v_t - g(x_t; xi))   # same xi!
  communication step (mod(t+1, tau) == 0):
      x_half    = x_t - gamma_t * v_t
      h_{t+1}   = x_ref - x_half            # accumulated descent this round
      y_{t+1}   = mix(y + h_{t+1} - h_prev) # SGT: slow gradient tracking
      x_{t+1}   = mix(x_ref - y_{t+1})      # SPA: slow partial averaging
      v_{t+1}   = full_grad(x_{t+1})        # MVR reset keeps E[V_t] unbiased

The step counter and the schedules live on the host: gamma and alpha are
fp32-rounded Python floats, handed to the kernels as fp32 arguments, so a
step never waits on the device.  ``fuse_tracking_buffers=True`` stores
``z = y - h_prev`` in place of ``(y, h_prev)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..kernels import api as fused
from ..tree import tree_map
from .algorithm import CommSpec, DecentralizedAlgorithm

Tree = Any
GradFn = Callable[[Tree], Tree]
MixFn = Callable[[Tree], Tree]
ScheduleOrFloat = Any

__all__ = ["DSEState", "DSEMVR", "DSESGD", "tree_axpy", "tree_sub", "tree_add"]


def _sched(v: ScheduleOrFloat, t: int) -> float:
    """A hyperparameter at step ``t``, as an fp32-rounded host float."""
    return float(np.float32(v(t) if callable(v) else v))


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_axpy(alpha: float, x: Tree, y: Tree) -> Tree:
    """alpha * x + y, preserving y's dtype."""
    return tree_map(lambda xi, yi: (alpha * xi + yi).to(yi.dtype), x, y)


def _cast_like(src: Tree, ref: Tree) -> Tree:
    return tree_map(lambda s, r: s.to(r.dtype), src, ref)


def _zeros_like(tree: Tree, dtype) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device), tree)


@dataclasses.dataclass
class DSEState:
    """State of DSE-MVR / DSE-SGD (node-stacked in the Simulator).

    ``y`` and ``h_prev`` are None when the tracking buffers are fused into
    ``z``; ``z`` is None otherwise.  ``step`` is the global iteration t,
    kept on the host.  ``comp`` is the gossip channel's wire state
    (``repro_torch.compression.ChannelState``), None without a channel;
    the executor owns it and the updates pass it through.
    """

    params: Tree
    x_ref: Tree                   # x at the start of the current round
    v: Optional[Tree]             # MVR direction estimate
    y: Optional[Tree]             # SGT tracked global accumulated direction
    h_prev: Optional[Tree]        # h from the previous round
    z: Optional[Tree]             # fused y - h_prev buffer
    step: int                     # global iteration t
    comp: Optional[Any] = None    # gossip-channel wire state


@dataclasses.dataclass(frozen=True)
class DSEMVR(DecentralizedAlgorithm):
    """Decentralized local updates with Dual-Slow Estimation + MVR (Alg. 1)."""

    lr: ScheduleOrFloat
    alpha: ScheduleOrFloat = 1.0
    tau: int = 1
    fuse_tracking_buffers: bool = False
    state_dtype: Any = None        # None => match params dtype
    #: route the update arithmetic through the fused-op backend
    #: (``repro_torch.kernels.api``): one launch per dtype bucket for the
    #: x step, the MVR update and the dual-slow combine
    use_fused: bool = False
    compression: Any = None
    channel: Any = None
    overlap: bool = False

    comm = CommSpec(cadence="every_tau", buffers=("y", "params"), reset="full")
    # v estimates the gradient; y tracks the round's displacement (scale
    # lr * tau), which is not comparable with the gradient
    tracking_buffer = "v"

    # -- state ------------------------------------------------------------
    def init(self, params: Tree, full_grad_fn: Optional[GradFn] = None) -> DSEState:
        """v_0 = full local gradient (Alg. 1 line 3); zeros if fn not given."""
        dt = self.state_dtype
        v0 = (
            _cast_like(full_grad_fn(params), _zeros_like(params, dt))
            if full_grad_fn is not None
            else _zeros_like(params, dt)
        )
        if self.fuse_tracking_buffers:
            y = h_prev = None
            z = _zeros_like(params, dt)
        else:
            y, h_prev = _zeros_like(params, dt), _zeros_like(params, dt)
            z = None
        return DSEState(
            params=params,
            x_ref=tree_map(torch.clone, params),
            v=v0, y=y, h_prev=h_prev, z=z, step=0,
        )

    # -- inner (local) update ----------------------------------------------
    def local_update(self, state: DSEState, grad_fn: GradFn) -> DSEState:
        """One local MVR step.  ``grad_fn`` closes over ONE minibatch xi and is
        evaluated at both x_{t+1} and x_t (the paper's same-sample rule)."""
        gamma = _sched(self.lr, state.step)
        alpha = _sched(self.alpha, state.step + 1)
        if self.use_fused:
            x_new = fused.tree_axpby(-gamma, state.v, 1.0, state.params)
            g_new = grad_fn(x_new)
            g_old = grad_fn(state.params)
            v_new = fused.tree_mvr_update(g_new, state.v, g_old, alpha)
        else:
            x_new = tree_axpy(-gamma, state.v, state.params)
            g_new = grad_fn(x_new)
            g_old = grad_fn(state.params)
            one_minus = float(np.float32(1.0) - np.float32(alpha))
            v_new = tree_map(
                lambda gn, v, go: (gn + one_minus * (v.to(gn.dtype) - go)).to(v.dtype),
                g_new, state.v, g_old,
            )
        return dataclasses.replace(state, params=x_new, v=v_new, step=state.step + 1)

    # -- communication round -------------------------------------------------
    def comm_update(
        self,
        state: DSEState,
        mix_fn: MixFn,
        grad_fn: Optional[GradFn] = None,
        reset_grad_fn: Optional[GradFn] = None,
    ) -> DSEState:
        """The SGT + SPA + v-reset step (Alg. 1 lines 7-11).

        ``reset_grad_fn`` computes the local gradient of the MVR reset
        (falls back to ``grad_fn``); with both None, v is kept.
        """
        reset_grad_fn = reset_grad_fn if reset_grad_fn is not None else grad_fn
        gamma = _sched(self.lr, state.step)
        if self.use_fused:
            # one combine pass computes x_half, h and the SGT pre-mix message;
            # the z refresh and the SPA subtraction are axpby launches (they
            # cannot fuse across the gossip)
            # each whole-tree temporary is dropped once dead, so that the
            # second gossip does not hold the first one's (a full-width
            # model's tree is GBs a node)
            if self.fuse_tracking_buffers:
                u, h_new = fused.tree_dse_combine(
                    state.params, state.v, state.x_ref, state.z, gamma
                )
                y_new = mix_fn(u)
                del u
                y_upd = dict(z=fused.tree_axpby(-1.0, h_new, 1.0, y_new))
                del h_new
            else:
                u, h_new = fused.tree_dse_combine_yh(
                    state.params, state.v, state.x_ref, state.y, state.h_prev, gamma
                )
                y_new = mix_fn(u)
                del u
                y_upd = dict(y=y_new, h_prev=h_new)
            x_pre = fused.tree_axpby(-1.0, y_new, 1.0, state.x_ref, like=state.params)
            del y_new
            x_new = mix_fn(x_pre)
            del x_pre
        else:
            x_half = tree_axpy(-gamma, state.v, state.params)
            h_new = tree_sub(_cast_like(state.x_ref, x_half), x_half)  # x_ref - x_half
            h_new = _cast_like(h_new, state.v)
            if self.fuse_tracking_buffers:
                y_new = mix_fn(tree_add(state.z, h_new))
                y_upd = dict(z=tree_sub(y_new, h_new))
            else:
                y_new = mix_fn(tree_add(state.y, tree_sub(h_new, state.h_prev)))
                y_upd = dict(y=y_new, h_prev=h_new)
            x_new = mix_fn(tree_axpy(-1.0, _cast_like(y_new, state.x_ref), state.x_ref))
        x_new = _cast_like(x_new, state.params)
        v_new = state.v
        if reset_grad_fn is not None:
            v_new = _cast_like(reset_grad_fn(x_new), state.v)
        return dataclasses.replace(
            state,
            params=x_new,
            x_ref=tree_map(torch.clone, x_new),
            v=v_new,
            step=state.step + 1,
            **y_upd,
        )


@dataclasses.dataclass(frozen=True)
class DSESGD(DSEMVR):
    """DSE-SGD (Alg. 2): plain minibatch SGD inner update + dual-slow estimation."""

    alpha: ScheduleOrFloat = 1.0

    # like DSE-MVR but v resets with a fresh *minibatch* gradient (Alg. 2)
    comm = CommSpec(cadence="every_tau", buffers=("y", "params"), reset="minibatch")

    def local_update(self, state: DSEState, grad_fn: GradFn) -> DSEState:
        gamma = _sched(self.lr, state.step)
        if self.use_fused:
            x_new = fused.tree_axpby(-gamma, state.v, 1.0, state.params)
        else:
            x_new = tree_axpy(-gamma, state.v, state.params)
        g_new = _cast_like(grad_fn(x_new), state.v)
        return dataclasses.replace(state, params=x_new, v=g_new, step=state.step + 1)

    def comm_update(
        self,
        state: DSEState,
        mix_fn: MixFn,
        grad_fn: Optional[GradFn] = None,
        reset_grad_fn: Optional[GradFn] = None,
    ) -> DSEState:
        state = DSEMVR.comm_update(self, state, mix_fn, None, None)
        rf = reset_grad_fn if reset_grad_fn is not None else grad_fn
        if rf is not None:  # v_{t+1} = g(x_{t+1}), fresh minibatch
            state = dataclasses.replace(state, v=_cast_like(rf(state.params), state.v))
        return state
