"""LR / control-parameter schedules, evaluated on the host in float32.

Counterpart of ``repro.optim.schedules``.  A schedule maps the host step
counter ``t`` to a Python float that is exactly the fp32 value the
reference computes, so the kernels receive it as an fp32 argument and no
step waits on the device.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "constant", "step_decay", "cosine", "warmup_cosine",
    "paper_mnist_schedule", "paper_cifar_schedule", "decay_weight",
]

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


def _cos32(x) -> np.float32:
    """The fp32 cosine of an fp32 argument, correctly rounded (within one
    fp32 ulp of XLA's)."""
    return _f32(math.cos(float(x)))


def cosine(base: float, total_steps: int, final_frac: float = 0.0):
    def fn(t):
        frac = min(max(_f32(t) / _f32(total_steps), _f32(0.0)), _f32(1.0))
        c = _cos32(_f32(math.pi) * frac)
        return float(_f32(base) * (_f32(final_frac) + _f32(1 - final_frac) * _f32(0.5)
                                   * (_f32(1.0) + c)))

    return fn


def warmup_cosine(base: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine(base, max(total_steps - warmup, 1), final_frac)

    def fn(t):
        t = _f32(t)
        if t < warmup:
            return float(_f32(base) * (t + _f32(1.0)) / _f32(warmup))
        return cos(t - _f32(warmup))

    return fn


def paper_mnist_schedule(base: float, total_steps: int):
    """Paper §6: divide LR by 2 at 0.5T and 0.75T (MNIST, T=400)."""
    return step_decay(base, [int(0.5 * total_steps), int(0.75 * total_steps)], [0.5, 0.25])


def paper_cifar_schedule(base: float, total_steps: int):
    """Paper §6: 0.1x at 0, 1x at 0.1T, 0.1x at 0.75T, 0.01x at 0.9T
    (values relative to the mid-phase base)."""
    return step_decay(
        base,
        [int(0.1 * total_steps), int(0.75 * total_steps), int(0.9 * total_steps)],
        [10.0, 1.0, 0.1],
    )


def decay_weight(base: float, rate: float = 0.99):
    """Paper's alpha decay: alpha_t = base * rate^t, all in float32."""
    return lambda t: float(_f32(base) * _f32(rate) ** _f32(t))
