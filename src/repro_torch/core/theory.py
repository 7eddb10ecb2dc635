"""Convergence theory (paper §3.1, Theorems 1-2) and the Fig. 3 synthetic
experiment, port of repro/core/theory.py.

Theorem 1 (SR, from Li et al. 2017):
    E[F(wbar_T) - F(w*)] <= D^2/(2 eta sqrt(T)) + eta G^2/sqrt(T) + sqrt(d) Delta G / 2

Theorem 2 (DR, this paper), with T0 = floor(2 eta G / (sqrt(d) Delta)):
    ... + 3 eta G^2/sqrt(T) + sqrt(d) Delta G / 2
        + sqrt(d) D Delta sum_{t<=T0} sqrt(t) / (2 eta T) + (T - T0) D G / T

The synthetic experiment minimizes f(w) = (w - 0.5)^2 for n parameters with
eta_t = eta/sqrt(t), Delta = 0.01, m = 8: SR tracks full precision, DR stalls
once |eta_t f'(w)| < Delta/2 (Remark 1).  The reference's ``lax.scan`` is a
loop over tensors here; the initial weights and the SR noise are operands
(or drawn from a ``torch.Generator``), so a test can hand in JAX's draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.core import quant


def sr_bound(D: float, G: float, eta: float, d: int, delta: float, T: int) -> float:
    """RHS of Theorem 1 (Eq. 11)."""
    return (D * D / (2.0 * eta * math.sqrt(T)) + eta * G * G / math.sqrt(T)
            + math.sqrt(d) * delta * G / 2.0)


def dr_bound(D: float, G: float, eta: float, d: int, delta: float, T: int) -> float:
    """RHS of Theorem 2 (Eq. 12)."""
    T0 = min(int(2.0 * eta * G / (math.sqrt(d) * delta)), T)
    sum_sqrt = sum(math.sqrt(t) for t in range(1, T0 + 1))
    return (D * D / (2.0 * eta * math.sqrt(T)) + 3.0 * eta * G * G / math.sqrt(T)
            + math.sqrt(d) * delta * G / 2.0
            + math.sqrt(d) * D * delta * sum_sqrt / (2.0 * eta * T)
            + (T - T0) * D * G / T)


class SyntheticResult(NamedTuple):
    w_final: torch.Tensor  # [n] parameters after T iterations
    mean_abs_err: torch.Tensor  # [T] mean |w - 0.5| trajectory
    stalled_frac: torch.Tensor  # [T] fraction with |eta_t f'(w)| < Delta/2 (Remark 1)


def synthetic_experiment(method: str, *, iters: int = 1000, n: int = 1000, eta: float = 0.3,
                         delta: float = 0.01, bits: int = 8, w0: torch.Tensor | None = None,
                         noise: torch.Tensor | None = None,
                         generator: torch.Generator | None = None,
                         device: str | torch.device = "cuda") -> SyntheticResult:
    """min_w (w - 0.5)^2, n params init U[0, 1), eta_t = eta/sqrt(t);
    ``method`` is 'fp', 'dr' or 'sr'.

    Runs on ``device`` (the card unless the caller asks for the CPU).
    ``w0`` [n] are the initial weights and ``noise`` [iters, n] the SR draw
    of each iteration; either, when None, comes from ``generator`` (one on
    ``device`` seeded 0 by default).  eta = 0.3, not the paper's 1: at
    eta = 1 the multiplier (1 - 2 eta_t) is exactly 0 at t = 4 and every
    method lands on w* in four steps (the reference's deviation note).
    """
    dev = _device.resolve(device)
    if generator is None and (w0 is None or (method == "sr" and noise is None)):
        generator = torch.Generator(device=dev).manual_seed(0)
    if w0 is None:
        w0 = torch.rand((n,), generator=generator, dtype=torch.float32,
                        device=generator.device)
    w = w0.to(dev, torch.float32)
    if method in ("dr", "sr"):
        w = quant.quantize(w, delta, bits, "dr")
    if method == "sr" and noise is None:
        noise = torch.rand((iters, w.numel()), generator=generator, dtype=torch.float32,
                           device=generator.device)
    if noise is not None:
        noise = noise.to(dev)
    errs, stalls = [], []
    for t in range(1, iters + 1):
        eta_t = torch.tensor(eta, dtype=torch.float32, device=dev) / torch.sqrt(
            torch.tensor(float(t), dtype=torch.float32, device=dev))
        g = 2.0 * (w - 0.5)
        upd = w - eta_t * g
        if method == "fp":
            w = upd
        elif method == "dr":
            w = quant.quantize(upd, delta, bits, "dr")
        elif method == "sr":
            w = quant.quantize(upd, delta, bits, "sr", noise[t - 1])
        else:
            raise ValueError(f"unknown method {method!r}")
        stalls.append(torch.mean((torch.abs(eta_t * g) < delta / 2.0).to(torch.float32)))
        errs.append(torch.mean(torch.abs(w - 0.5)))
    return SyntheticResult(w_final=w, mean_abs_err=torch.stack(errs),
                           stalled_frac=torch.stack(stalls))
