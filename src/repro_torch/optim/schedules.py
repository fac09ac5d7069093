"""LR / control-parameter schedules, evaluated on the host in float32.

Counterpart of ``repro.optim.schedules``.  A schedule maps the host step
counter ``t`` to a Python float that is exactly the fp32 value the
reference computes, so the kernels receive it as an fp32 argument and no
step waits on the device.
"""
from __future__ import annotations

import numpy as np

__all__ = ["constant", "step_decay", "paper_mnist_schedule", "decay_weight"]

_f32 = np.float32


def constant(value: float):
    return lambda t: float(_f32(value))


def step_decay(base: float, boundaries, factors):
    """Piecewise: value = base * factor[i] for t >= boundaries[i]."""
    fs = [1.0] + list(factors)

    def fn(t):
        idx = sum(int(t) >= b for b in boundaries)
        return float(_f32(base) * _f32(fs[idx]))

    return fn


def paper_mnist_schedule(base: float, total_steps: int):
    """Paper §6: divide LR by 2 at 0.5T and 0.75T (MNIST, T=400)."""
    return step_decay(base, [int(0.5 * total_steps), int(0.75 * total_steps)], [0.5, 0.25])


def decay_weight(base: float, rate: float = 0.99):
    """Paper's alpha decay: alpha_t = base * rate^t, all in float32."""
    return lambda t: float(_f32(base) * _f32(rate) ** _f32(t))
