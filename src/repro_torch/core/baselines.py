"""The baselines the paper compares against, in PyTorch.

Counterpart of ``repro.core.baselines``: the same six methods on the same
interface (``init`` / ``local_update`` / ``comm_update`` / ``comm``), each
with both ``use_fused`` branches.  Every-step methods (DSGD, GT-DSGD,
GT-HSGD) declare ``cadence="every_step"`` and are driven through
``comm_update`` alone (GT-DSGD and GT-HSGD have no ``local_update``).  The
step counter lives on the host, as in ``dse.py``; the fused branches hand
fp32-rounded host scalars to the kernels.

  DSGD      Lian et al. 2017  (decentralized parallel SGD, gossip every step)
  DLSGD     Li et al. 2019    (decentralized local SGD: tau local steps + gossip)
  GT-DSGD   Xin et al. 2021   (gradient tracking every step)
  GT-HSGD   Xin et al. 2021   (hybrid variance reduction + gradient tracking)
  PD-SGDM   Gao & Huang 2020  (periodic decentralized momentum SGD)
  SlowMo-D  Wang et al. 2019  (slow momentum outer update on gossiped iterates)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..kernels import api as fused
from ..tree import tree_map
from .algorithm import CommSpec, DecentralizedAlgorithm
from .dse import GradFn, ScheduleOrFloat, Tree, _cast_like, _sched, tree_axpy

__all__ = [
    "DSGD", "DLSGD", "GTDSGD", "GTHSGD", "PDSGDM", "SlowMoD",
    "SGDState", "GTState", "GTHSGDState", "MomentumState", "SlowMoState",
]

_f32 = np.float32


def _zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


@dataclasses.dataclass
class SGDState:
    params: Tree
    step: int
    comp: Optional[Any] = None    # gossip-channel wire state


@dataclasses.dataclass(frozen=True)
class DLSGD(DecentralizedAlgorithm):
    """tau local SGD steps, then gossip the parameters."""

    lr: ScheduleOrFloat
    tau: int = 1
    use_fused: bool = False
    compression: Any = None
    channel: Any = None
    overlap: bool = False

    comm = CommSpec(cadence="every_tau", buffers=("params",))

    def init(self, params: Tree, full_grad_fn: Optional[GradFn] = None) -> SGDState:
        del full_grad_fn
        return SGDState(params=params, step=0)

    def local_update(self, state: SGDState, grad_fn: GradFn) -> SGDState:
        gamma = _sched(self.lr, state.step)
        g = grad_fn(state.params)
        if self.use_fused:
            x_new = fused.tree_axpby(-gamma, g, 1.0, state.params)
        else:
            x_new = tree_axpy(-gamma, g, state.params)
        return dataclasses.replace(state, params=x_new, step=state.step + 1)

    def comm_update(self, state, mix_fn, grad_fn=None, reset_grad_fn=None) -> SGDState:
        state = self.local_update(state, grad_fn)
        return dataclasses.replace(state, params=mix_fn(state.params))


@dataclasses.dataclass(frozen=True)
class DSGD(DLSGD):
    """Decentralized SGD: gossip after every step (DLSGD with tau=1)."""

    tau: int = 1

    comm = CommSpec(cadence="every_step", buffers=("params",))


@dataclasses.dataclass
class GTState:
    params: Tree
    y: Tree          # tracked global gradient estimate
    g_prev: Tree     # g_t (for the tracking correction)
    step: int
    comp: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class GTDSGD(DecentralizedAlgorithm):
    """Gradient-tracking DSGD (communicates x and y every step).

      x_{t+1} = mix(x_t) - gamma * y_t
      y_{t+1} = mix(y_t) + g_{t+1} - g_t
    """

    lr: ScheduleOrFloat
    tau: int = 1   # fixed: GT-DSGD is a non-local-update method
    use_fused: bool = False
    compression: Any = None
    channel: Any = None
    overlap: bool = False

    comm = CommSpec(cadence="every_step", buffers=("params", "y"))
    tracking_buffer = "y"

    def init(self, params: Tree, full_grad_fn: Optional[GradFn] = None) -> GTState:
        g0 = full_grad_fn(params) if full_grad_fn is not None else _zeros_like(params)
        return GTState(params=params, y=g0, g_prev=g0, step=0)

    def comm_update(self, state: GTState, mix_fn, grad_fn=None, reset_grad_fn=None) -> GTState:
        gamma = _sched(self.lr, state.step)
        if self.use_fused:
            x_new = fused.tree_axpby(-gamma, state.y, 1.0, mix_fn(state.params))
            g_new = grad_fn(x_new)
            y_new = fused.tree_add_sub(mix_fn(state.y), g_new, state.g_prev)
            return GTState(params=x_new, y=y_new, g_prev=g_new, step=state.step + 1)
        x_new = tree_axpy(-gamma, state.y, mix_fn(state.params))
        g_new = grad_fn(x_new)
        y_new = tree_map(
            lambda ym, gn, gp: (ym + gn - gp).to(ym.dtype),
            mix_fn(state.y), g_new, state.g_prev,
        )
        return GTState(params=x_new, y=y_new, g_prev=g_new, step=state.step + 1)


@dataclasses.dataclass
class GTHSGDState:
    params: Tree
    v: Tree          # hybrid variance-reduced local estimator
    y: Tree          # tracked global direction
    step: int
    comp: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class GTHSGD(DecentralizedAlgorithm):
    """GT-HSGD (Xin, Khan & Kar 2021): hybrid (STORM-style) variance
    reduction + gradient tracking, communicating every iteration.

      v_t     = g(x_t; xi) + (1 - beta)(v_{t-1} - g(x_{t-1}; xi))   # same xi
      y_t     = mix(y_{t-1}) + v_t - v_{t-1}
      x_{t+1} = mix(x_t) - gamma y_t
    """

    lr: ScheduleOrFloat
    beta: float = 0.1
    tau: int = 1   # communicates every step
    use_fused: bool = False
    compression: Any = None
    channel: Any = None
    overlap: bool = False

    comm = CommSpec(cadence="every_step", buffers=("params", "y"))
    tracking_buffer = "y"

    def init(self, params: Tree, full_grad_fn: Optional[GradFn] = None) -> GTHSGDState:
        v0 = full_grad_fn(params) if full_grad_fn is not None else _zeros_like(params)
        return GTHSGDState(params=params, v=v0, y=tree_map(torch.clone, v0), step=0)

    def comm_update(self, state: GTHSGDState, mix_fn, grad_fn=None,
                    reset_grad_fn=None) -> GTHSGDState:
        gamma = _sched(self.lr, state.step)
        if self.use_fused:
            # the STORM-style v update is the mvr_update shape (alpha = beta),
            # the tracking correction is add_sub: one launch each per bucket
            x_new = fused.tree_axpby(-gamma, state.y, 1.0, mix_fn(state.params))
            g_new = grad_fn(x_new)
            g_old = grad_fn(state.params)
            v_new = fused.tree_mvr_update(g_new, state.v, g_old, self.beta)
            y_new = fused.tree_add_sub(mix_fn(state.y), v_new, state.v)
            return GTHSGDState(params=x_new, v=v_new, y=y_new, step=state.step + 1)
        x_new = tree_axpy(-gamma, state.y, mix_fn(state.params))
        g_new = grad_fn(x_new)
        g_old = grad_fn(state.params)
        one_minus = 1.0 - self.beta   # a Python float, rounded to fp32 by the multiply
        v_new = tree_map(
            lambda gn, v, go: (gn + one_minus * (v - go)).to(v.dtype),
            g_new, state.v, g_old,
        )
        y_new = tree_map(
            lambda ym, vn, vp: (ym + vn - vp).to(ym.dtype),
            mix_fn(state.y), v_new, state.v,
        )
        return GTHSGDState(params=x_new, v=v_new, y=y_new, step=state.step + 1)


@dataclasses.dataclass
class MomentumState:
    params: Tree
    m: Tree
    step: int
    comp: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class PDSGDM(DecentralizedAlgorithm):
    """Periodic decentralized SGD with (local) momentum."""

    lr: ScheduleOrFloat
    tau: int = 1
    beta: float = 0.9
    nesterov: bool = False
    use_fused: bool = False
    compression: Any = None
    channel: Any = None
    overlap: bool = False

    comm = CommSpec(cadence="every_tau", buffers=("params",))

    def init(self, params: Tree, full_grad_fn: Optional[GradFn] = None) -> MomentumState:
        del full_grad_fn
        return MomentumState(params=params, m=_zeros_like(params), step=0)

    def local_update(self, state: MomentumState, grad_fn: GradFn) -> MomentumState:
        gamma = _sched(self.lr, state.step)
        g = grad_fn(state.params)
        if self.use_fused:
            m_new = fused.tree_axpby(self.beta, state.m, 1.0, g, like=state.m)
            d = fused.tree_axpby(self.beta, m_new, 1.0, g) if self.nesterov else m_new
            x_new = fused.tree_axpby(-gamma, d, 1.0, state.params)
            return dataclasses.replace(state, params=x_new, m=m_new, step=state.step + 1)
        m_new = tree_map(lambda m, gi: (self.beta * m + gi).to(m.dtype), state.m, g)
        d = tree_map(lambda m, gi: self.beta * m + gi, m_new, g) if self.nesterov else m_new
        return dataclasses.replace(
            state, params=tree_axpy(-gamma, d, state.params), m=m_new, step=state.step + 1,
        )

    def comm_update(self, state, mix_fn, grad_fn=None, reset_grad_fn=None) -> MomentumState:
        state = self.local_update(state, grad_fn)
        return dataclasses.replace(state, params=mix_fn(state.params))


@dataclasses.dataclass
class SlowMoState:
    params: Tree
    x_ref: Tree      # params at round start
    u: Tree          # slow momentum buffer
    step: int
    comp: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class SlowMoD(DecentralizedAlgorithm):
    """SlowMo with a Local-SGD inner optimizer and gossip averaging.

    Inner: tau local SGD steps.  Outer (every tau steps):
      x_avg    = mix(x_inner)
      u_{k+1}  = beta * u_k + (x_ref - x_avg) / gamma
      x_{k+1}  = x_ref - slow_lr * gamma * u_{k+1}
    """

    lr: ScheduleOrFloat
    tau: int = 1
    slow_lr: float = 1.0
    beta: float = 0.95
    use_fused: bool = False
    compression: Any = None
    channel: Any = None
    overlap: bool = False

    comm = CommSpec(cadence="every_tau", buffers=("params",))

    def init(self, params: Tree, full_grad_fn: Optional[GradFn] = None) -> SlowMoState:
        del full_grad_fn
        return SlowMoState(
            params=params, x_ref=tree_map(torch.clone, params), u=_zeros_like(params), step=0,
        )

    def local_update(self, state: SlowMoState, grad_fn: GradFn) -> SlowMoState:
        gamma = _sched(self.lr, state.step)
        g = grad_fn(state.params)
        if self.use_fused:
            x_new = fused.tree_axpby(-gamma, g, 1.0, state.params)
        else:
            x_new = tree_axpy(-gamma, g, state.params)
        return dataclasses.replace(state, params=x_new, step=state.step + 1)

    def comm_update(self, state: SlowMoState, mix_fn, grad_fn=None,
                    reset_grad_fn=None) -> SlowMoState:
        # gamma of the round's last step, read BEFORE its local update; the
        # returned step is the one that update already advanced
        gamma = _sched(self.lr, state.step)
        state = self.local_update(state, grad_fn)
        x_avg = mix_fn(state.params)
        # the reference's fp32 scalar arithmetic on gamma, on the host
        inv_gamma = float(_f32(1.0) / _f32(gamma))
        slow_step = float(_f32(-self.slow_lr) * _f32(gamma))
        if self.use_fused:
            drift = fused.tree_axpby(inv_gamma, state.x_ref, -inv_gamma, x_avg, like=state.u)
            u_new = fused.tree_axpby(self.beta, state.u, 1.0, drift, like=state.u)
            x_new = fused.tree_axpby(slow_step, u_new, 1.0, state.x_ref, like=state.params)
        else:
            u_new = tree_map(
                lambda u, xr, xa: (self.beta * u + (xr.float() - xa.float()) / gamma).to(u.dtype),
                state.u, state.x_ref, x_avg,
            )
            x_new = tree_axpy(slow_step, u_new, _cast_like(state.x_ref, state.params))
        return SlowMoState(
            params=x_new, x_ref=tree_map(torch.clone, x_new), u=u_new, step=state.step,
        )
