"""DeepLight-style magnitude pruning (Deng et al. 2021; paper §4.1/B.2), port
of repro/core/pruning.py.

Train dense for a warmup, then prune and retrain with a ratio that grows as
R_x * (1 - D^{k/U}) (R_x target sparsity, k the step past warmup, D/U
damping).  Pruned weights may grow back: the mask is recomputed from the
current magnitudes every ``update_every`` steps.

The threshold is the ratio-quantile of |w| with linear interpolation, as
``jnp.quantile`` computes it under ``jax.jit``; ``torch.quantile`` refuses
inputs above 2^24 elements (the full Avazu table holds 70,852,496 weights),
so :func:`quantile_linear` takes the two neighbours from one sort.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ref


class PruneState(NamedTuple):
    weights: torch.Tensor  # f32 [n, d]
    mask: torch.Tensor  # bool [n, d]
    step: int  # the pruning schedule's clock (host-driven)


class PruneConfig(NamedTuple):
    target_sparsity: float = 0.5  # R_x (paper: 0.5 -> 2x inference ratio)
    damping: float = 0.99  # D
    damping_steps: int = 3000  # U
    warmup_steps: int = 200
    update_every: int = 10


def init_prune(generator: torch.Generator, n: int, d: int, *,
               init_scale: float = 1e-2) -> PruneState:
    w = torch.randn((n, d), generator=generator, dtype=torch.float32,
                    device=generator.device) * init_scale
    return PruneState(weights=w, mask=torch.ones((n, d), dtype=torch.bool, device=w.device),
                      step=0)


def prune_ratio(cfg: PruneConfig, step: int) -> float:
    """R_x * (1 - D^{k/U}) after warmup, 0 before, as a float32 value.

    The reference evaluates it in float32 on the device; XLA:CPU turns the
    division by the constant U into a multiply by its float32 reciprocal,
    and its ``pow`` is the C library's ``powf``, which numpy's float32 power
    calls too (tests/test_torch_methods_extra.py sweeps the steps)."""
    f32 = np.float32
    if step < cfg.warmup_steps:
        return 0.0
    k = max(f32(step) - f32(cfg.warmup_steps), f32(0.0))
    e = k * (f32(1.0) / f32(cfg.damping_steps))
    return float(f32(cfg.target_sparsity) * (f32(1.0) - f32(cfg.damping) ** e))


def quantile_linear(values: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(values, q)`` (linear interpolation) as a 0-d float32
    tensor, bitwise as the jitted reference computes it: one sort, the
    position ``q * (n - 1)`` in float32, its floor and ceil clamped to the
    range, and ``fma(hi, w_hi, lo * w_lo)`` (XLA:CPU contracts the
    interpolation's sum of products so).  Any NaN makes the result NaN.
    Takes any number of elements."""
    f32 = np.float32
    flat = values.reshape(-1).to(torch.float32)
    n = flat.numel()
    pos = f32(q) * (f32(n) - f32(1.0))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = f32(pos - lo)
    w_lo = f32(f32(1.0) - w_hi)
    i_lo = int(min(max(lo, f32(0.0)), f32(n - 1)))
    i_hi = int(min(max(hi, f32(0.0)), f32(n - 1)))
    srt = torch.sort(flat).values
    out = ref.fma(srt[i_hi], float(w_hi), srt[i_lo] * float(w_lo))
    return torch.where(torch.isnan(flat).any(), torch.nan, out)


def update_mask(state: PruneState, cfg: PruneConfig) -> PruneState:
    """Recompute the magnitude mask at the scheduled ratio (regrowth allowed);
    a ratio of 0 keeps every weight."""
    ratio = prune_ratio(cfg, state.step)
    if ratio <= 0.0:
        return state._replace(mask=state.weights == state.weights)
    thresh = quantile_linear(torch.abs(state.weights), ratio)
    return state._replace(mask=torch.abs(state.weights) > thresh)


def prune_lookup(state: PruneState, ids: torch.Tensor) -> torch.Tensor:
    return state.weights[ids] * state.mask[ids]


def sparsity(state: PruneState) -> torch.Tensor:
    return 1.0 - torch.mean(state.mask.to(torch.float32))
