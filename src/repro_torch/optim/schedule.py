"""Learning-rate schedules (port of repro/optim/schedule.py, the CTR ones).

Paper §4.1: lr 1e-3, reduced tenfold after chosen steps.  Each returns the
learning rate at a host step as a float32 value, computed in float32 as the
reference computes it.  The constant, inverse-sqrt and cosine schedules come
with the LM slice.
"""
from __future__ import annotations

import numpy as np


def step_decay_schedule(lr: float, boundaries: tuple[int, ...], factor: float = 0.1):
    """Multiply by ``factor`` at each boundary step."""

    def fn(step: int) -> float:
        mult = np.float32(1.0)
        for b in boundaries:
            mult = mult * (np.float32(factor) if step >= b else np.float32(1.0))
        return float(np.float32(lr) * mult)

    return fn
