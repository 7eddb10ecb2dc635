"""Learning-rate schedules (port of repro/optim/schedule.py).

Paper §4.1: lr 1e-3, reduced tenfold after chosen steps; the theory (§3.1)
assumes eta_t = eta / sqrt(t), which :func:`inv_sqrt_schedule` provides.
Each schedule returns the learning rate at a host step as a float32 value,
computed as XLA:CPU computes the reference's jitted float32 arithmetic:

* a division by a constant is a multiply by its float32 reciprocal
  (``cosine``'s ``step / total``), and ``warmup_cosine``'s ``lr * s /
  warmup`` folds into ``s * f32(lr / warmup)``;
* ``lr / sqrt(s)`` is ``lr * rsqrt(s)``;
* ``cosine``'s ``(1 - f) * 0.5 * (1 + cos)`` folds its constants into one,
  ``f32(1 - f) * 0.5``, and the add of ``final_frac`` contracts into an FMA.

XLA's ``rsqrt`` and ``cos`` are approximations within an ulp of the
correctly rounded values these take (``tests/test_torch_schedule.py``
states the tolerance that leaves).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ref


def _f32(x) -> np.float32:
    return np.float32(x)


def constant_schedule(lr: float):
    """``lr`` at every step."""

    def fn(step: int) -> float:
        return float(_f32(lr))

    return fn


def step_decay_schedule(lr: float, boundaries: tuple[int, ...], factor: float = 0.1):
    """Multiply by ``factor`` at each boundary step."""

    def fn(step: int) -> float:
        mult = _f32(1.0)
        for b in boundaries:
            mult = mult * (_f32(factor) if step >= b else _f32(1.0))
        return float(_f32(lr) * mult)

    return fn


def inv_sqrt_schedule(lr: float):
    """eta_t = eta / sqrt(t), t 1-indexed (the theory's schedule)."""

    def fn(step: int) -> float:
        s = max(_f32(step), _f32(1.0))
        return float(_f32(lr) * _f32(1.0 / math.sqrt(float(s))))

    return fn


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    """From ``lr`` down to ``final_frac * lr`` over ``total_steps`` by half a
    cosine, then flat."""
    inv_total = _f32(1.0) / _f32(max(total_steps, 1))
    half = float(_f32(1.0 - final_frac) * _f32(0.5))

    def fn(step: int) -> float:
        t = min(max(_f32(step) * inv_total, _f32(0.0)), _f32(1.0))
        cos = _f32(math.cos(float(t * _f32(math.pi))))
        inner = ref.fma(torch.tensor(cos + _f32(1.0)), half, float(_f32(final_frac)))
        return float(_f32(float(inner)) * _f32(lr))

    return fn


def warmup_cosine_schedule(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    """Linear warmup from 0 over ``warmup`` steps, then
    :func:`cosine_schedule` over the remaining ``total_steps - warmup``."""
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)
    rate = _f32(lr) / _f32(max(warmup, 1))

    def fn(step: int) -> float:
        if step < warmup:
            return float(_f32(step) * rate)
        return cos(step - warmup)

    return fn
