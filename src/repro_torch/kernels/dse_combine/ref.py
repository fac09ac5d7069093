"""Plain PyTorch versions of the fused dual-slow combine."""
from __future__ import annotations

import numpy as np

__all__ = ["dse_combine_ref", "dse_combine_yh_ref"]


def _h(params, v, x_ref, gamma):
    x_half = params.float() - float(np.float32(gamma)) * v.float()
    return x_ref.float() - x_half


def dse_combine_ref(params, v, x_ref, z, gamma):
    """(u, h): h = x_ref - (params - gamma*v); u = z + h.
    u keeps z's dtype, h keeps v's (the tracking-state dtype)."""
    h = _h(params, v, x_ref, gamma)
    u = z.float() + h
    return u.to(z.dtype), h.to(v.dtype)


def dse_combine_yh_ref(params, v, x_ref, y, h_prev, gamma):
    """(u, h): h = x_ref - (params - gamma*v); u = y + h - h_prev.
    u keeps y's dtype, h keeps v's."""
    h = _h(params, v, x_ref, gamma)
    u = y.float() + h - h_prev.float()
    return u.to(y.dtype), h.to(v.dtype)
