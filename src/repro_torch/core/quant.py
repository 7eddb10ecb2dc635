"""Uniform symmetric quantization primitives (port of repro/core/quant.py).

For m-bit quantization the integer codes lie in [-2^{m-1}, 2^{m-1} - 1] and
the value of code c is ``Delta * c`` (paper §2.1).  Two rounding functions
(Eq. 3/4): deterministic rounding (DR, ties up) and stochastic rounding (SR,
``floor(x) + [frac(x) > u]`` with the uniform noise ``u`` as an operand, so
the port and the reference round identically when handed the same noise).

Every function keeps the reference's operation order, so given the same
operands the codes are bitwise equal (tests/test_torch_quant.py).
:func:`fake_quant_lsq` is the LSQ fake-quantizer ALPT learns Delta through
(Eq. 6/7); the PACT variant comes with the QAT methods.
"""
from __future__ import annotations

from typing import Literal

import torch

Rounding = Literal["dr", "sr"]


def code_bounds(bits: int) -> tuple[int, int]:
    """Inclusive integer code range [n, p] for m-bit symmetric quantization."""
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def _broadcast_step(w: torch.Tensor, step) -> torch.Tensor:
    """Broadcast per-row step sizes against the trailing dim of ``w``."""
    step = torch.as_tensor(step, dtype=torch.float32, device=w.device)
    if step.ndim == 0 or step.ndim == w.ndim:
        return step
    if step.ndim == w.ndim - 1:
        return step.unsqueeze(-1)
    raise ValueError(f"step shape {tuple(step.shape)} incompatible with weights {tuple(w.shape)}")


def round_deterministic(x: torch.Tensor) -> torch.Tensor:
    """Eq. 3: floor(x) if frac < 0.5 else floor(x)+1 (ties round up)."""
    return torch.floor(x + 0.5)


def round_stochastic(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Eq. 4 with explicit uniform noise in [0, 1): floor(x) + (frac(x) > u)."""
    lo = torch.floor(x)
    return lo + (x - lo > noise).to(x.dtype)


def quantize_codes(w: torch.Tensor, step, bits: int, rounding: Rounding = "sr",
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 1: int8 codes ``R(clip(w / Delta, -2^{m-1}, 2^{m-1}-1))``."""
    n, p = code_bounds(bits)
    step = _broadcast_step(w, step)
    scaled = torch.clamp(w.to(torch.float32) / step, n, p)
    if rounding == "dr":
        codes = round_deterministic(scaled)
    elif rounding == "sr":
        if noise is None:
            raise ValueError("stochastic rounding requires noise")
        codes = round_stochastic(scaled, noise)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    return torch.clamp(codes, n, p).to(torch.int8)


def dequantize(codes: torch.Tensor, step) -> torch.Tensor:
    """Eq. 2: w_hat = Delta * w_tilde."""
    out = codes.to(torch.float32)
    return out * _broadcast_step(out, step)


def sr_noise(generator: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """Uniform [0, 1) noise for stochastic rounding, on the generator's device.

    Torch's stream is not JAX's threefry stream: parity tests hand both
    packages the same noise instead.
    """
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)


def init_step_size(w: torch.Tensor, bits: int, per_row: bool = True) -> torch.Tensor:
    """LSQ-style init: 2*mean(|w|)/sqrt(p) per row (or globally).

    The per-row mean sums each row left to right and scales by fp32(1/d):
    the order XLA:CPU takes for narrow rows, which makes the steps bitwise
    equal to the reference at the paper's d = 16 (and d = 15).  Wide rows
    XLA sums in vector lanes, and there the two agree to about an ulp.
    """
    p = 2 ** (bits - 1) - 1
    a = torch.abs(w.to(torch.float32))
    if per_row:
        total = a[..., 0]
        for j in range(1, a.shape[-1]):
            total = total + a[..., j]
        mean_abs = total * torch.tensor(1.0 / a.shape[-1], dtype=torch.float32,
                                        device=w.device)
    else:
        mean_abs = torch.mean(a)
    root_p = torch.sqrt(torch.tensor(float(p), dtype=torch.float32, device=w.device))
    return torch.clamp_min(2.0 * mean_abs / root_p, 1e-8).to(torch.float32)


def quantize(w: torch.Tensor, step, bits: int, rounding: Rounding = "sr",
             noise: torch.Tensor | None = None) -> torch.Tensor:
    """Full quantizer Q(w) = Delta * codes (Eq. 2): float values on the grid."""
    return dequantize(quantize_codes(w, step, bits, rounding, noise), step)


class _FakeQuantLSQ(torch.autograd.Function):
    """Forward Q_D(w, step); backward straight-through for ``w`` and Eq. 7
    for ``step`` (``repro/core/quant.py:119-158``)."""

    @staticmethod
    def forward(ctx, w, step, bits, grad_scale):
        ctx.save_for_backward(w, step)
        ctx.bits, ctx.grad_scale = bits, grad_scale
        return quantize(w, step, bits, rounding="dr")

    @staticmethod
    def backward(ctx, g):
        w, step = ctx.saved_tensors
        n, p = code_bounds(ctx.bits)
        scaled = w.to(torch.float32) / _broadcast_step(w, step)
        in_range = (scaled > n) & (scaled < p)
        # dQ/dw: straight-through inside the clip range, 0 outside.
        dw = (g * in_range).to(w.dtype)
        # dQ/dstep (Eq. 7): -2^{m-1} below, 2^{m-1}-1 above, R(w/D) - w/D inside.
        dstep_elem = torch.where(
            scaled <= n, float(n),
            torch.where(scaled >= p, float(p), round_deterministic(scaled) - scaled))
        dstep_full = g.to(torch.float32) * dstep_elem * ctx.grad_scale
        if step.ndim == 0:
            dstep = torch.sum(dstep_full)
        elif step.ndim == w.ndim - 1:
            dstep = torch.sum(dstep_full, dim=-1)
        else:
            dstep = dstep_full
        return dw, dstep.to(step.dtype), None, None


def fake_quant_lsq(w: torch.Tensor, step: torch.Tensor, bits: int,
                   grad_scale: float = 1.0) -> torch.Tensor:
    """Forward: Q_D(w, step) with DR.  Backward: STE for ``w``; Eq. 7 times
    ``grad_scale`` for ``step`` (paper §3.2: g = 1/sqrt(b*d*q)), summed over
    the trailing dim when ``step`` is per row."""
    return _FakeQuantLSQ.apply(w, step, bits, grad_scale)
