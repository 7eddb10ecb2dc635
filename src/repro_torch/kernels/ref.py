"""Plain PyTorch versions of the port's kernels (port of repro/kernels/ref.py).

Each function repeats its kernel's arithmetic in the same operation order as
the reference's jnp oracle, so the CUDA kernel, this version and the JAX
package agree bitwise on the same operands.  :mod:`repro_torch.kernels.ops`
runs these for tensors on the CPU; ``chip_smoke.py`` holds each kernel
against them on the card.

Where XLA:CPU compiles the reference's multiply-adds into fused
multiply-adds (one rounding), these versions call :func:`fma`, which rounds
once as ``__fmaf_rn`` does on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codestore import in_range_rows, pack_codes, unpack_codes


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in float64)."""
    return float(np.float32(x))


# Adam constants as the reference's kernel sees them: JAX rounds each Python
# float (``1.0 - b1`` is computed in float64 first) to float32 once.
B1, B2, EPS = f32(0.9), f32(0.999), f32(1e-8)
A1, A2 = f32(1.0 - 0.9), f32(1.0 - 0.999)


def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``like``'s device.  Divide by this, not
    by a Python float: on CUDA, PyTorch computes ``t / python_float`` as ``t *
    (1 / x)``, which is not the correctly rounded quotient."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (``__fsqrt_rn``).  PyTorch's CPU
    ``sqrt`` on float32 can miss by an ulp; the square root of the float64
    value, rounded to float32, cannot."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as ``__fmaf_rn`` (and a multiply-add
    that XLA:CPU contracts) computes it.

    The product of two float32 values is exact in float64; the sum is made
    exact by TwoSum and rounded to odd, so the final rounding to float32 is
    the only one that counts.  Scalars must already be float32 values.
    """
    t = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (torch.as_tensor(x, dtype=torch.float64, device=t.device)
               if not isinstance(x, torch.Tensor) else x.to(torch.float64)
               for x in (a, b, c))
    p = a * b
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    even = (s.view(torch.int64) & 1) == 0
    nudge = (err != 0) & even & torch.isfinite(s)
    s = torch.where(nudge, torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf), err)), s)
    return s.to(torch.float32)


def dequant_gather_ref(codes: torch.Tensor, step: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """``out[b] = f32(codes[ids[b]]) * step[ids[b]]`` -> f32 [b, d]."""
    rows = codes.index_select(0, ids).to(torch.float32)
    return rows * step.index_select(0, ids)[:, None]


def dequant_gather_packed_ref(packed: torch.Tensor, step: torch.Tensor,
                              ids: torch.Tensor, *, bits: int, d: int) -> torch.Tensor:
    """The same gather over a packed uint8 container ``[n, ceil(d*bits/8)]``."""
    rows = unpack_codes(packed.index_select(0, ids), bits, d).to(torch.float32)
    return rows * step.index_select(0, ids)[:, None]


def sr_round_ref(w: torch.Tensor, step: torch.Tensor, noise: torch.Tensor,
                 bits: int) -> torch.Tensor:
    """``clip(floor(s) + [s - floor(s) > u], lo, hi)`` with ``s = clip(w/step_row)``."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    scaled = torch.clamp(w.to(torch.float32) / step[:, None], lo, hi)
    base = torch.floor(scaled)
    up = (scaled - base > noise).to(torch.float32)
    return torch.clamp(base + up, lo, hi).to(torch.int8)


def adam_row_step(codes: torch.Tensor, step_rows: torch.Tensor, mu: torch.Tensor,
                  nu: torch.Tensor, g: torch.Tensor, lr: float, c1: float, c2: float,
                  weight_decay: float = 0.0):
    """One row-Adam step on de-quantized rows -> ``(w_new, mu', nu')``.

    ``codes`` f32 [k, d] (the integer codes as floats), ``step_rows`` [k];
    ``lr``, ``c1 = 1 - b1^t`` and ``c2 = 1 - b2^t`` are rounded to float32.  The
    arithmetic is the reference kernel body (``repro/kernels/sparse_row_update.py
    :51-58``) as XLA:CPU compiles it, which is where the reference's numbers
    come from: the two moment updates are fused multiply-adds, the quotient
    ``(mu'/c1) / (sqrt(nu'/c2) + eps)`` is rewritten as ``mu'' / (c1 *
    (sqrt(nu'/c2) + eps))`` with a numerator ``mu''`` that contracts the other
    product, and the final subtraction is fused too.
    """
    lr, c1, c2 = f32(lr), f32(c1), f32(c2)  # the kernel takes them as float32
    w = codes * step_rows[:, None]
    mu_new = fma(B1, mu, A1 * g)
    nu_new = fma(B2, nu, A2 * (g * g))
    upd = fma(A1, g, B1 * mu) / (c1 * (sqrt_rn(nu_new / scalar(c2, g)) + EPS))
    if weight_decay:
        upd = fma(f32(weight_decay), w, upd)
        w_new = fma(-lr, upd, w)
    else:
        w_new = fma(codes, step_rows[:, None], -(lr * upd))
    return w_new, mu_new, nu_new


def sparse_row_update_ref(codes: torch.Tensor, step: torch.Tensor, mu: torch.Tensor,
                          nu: torch.Tensor, uniq: torch.Tensor, g_sum: torch.Tensor,
                          noise: torch.Tensor, lr: float, c1: float, c2: float, bits: int,
                          *, weight_decay: float = 0.0) -> torch.Tensor:
    """The fused CTR row step over int8 ``codes`` [N, d]: gather, Adam, SR, scatter.

    **In place**: ``codes``, ``mu`` and ``nu`` rows at ``uniq`` are written
    with ``index_copy_`` (the reference's aliased outputs allow it); returns
    ``w_new`` f32 [K, d].  An id outside ``[0, N)`` (the dedup sentinel of a
    table with no scratch row) steps the clamped row and writes nothing, as
    the reference's ``mode="drop"`` scatter; duplicate in-range ids (the
    sentinel's scratch row) leave that row's bytes unspecified, as the
    reference says of its scratch row.
    """
    safe = _clamped(uniq, codes.shape[0])
    w_new, codes_rows, mu_rows, nu_rows = _row_step(
        codes.index_select(0, safe), step, mu, nu, safe, g_sum, noise, lr, c1, c2, bits,
        weight_decay)
    for t, rows in ((codes, codes_rows), (mu, mu_rows), (nu, nu_rows)):
        t.index_copy_(0, *in_range_rows(uniq, rows, t.shape[0]))
    return w_new


def sparse_row_update_packed_ref(packed: torch.Tensor, step: torch.Tensor, mu: torch.Tensor,
                                 nu: torch.Tensor, uniq: torch.Tensor, g_sum: torch.Tensor,
                                 noise: torch.Tensor, lr: float, c1: float, c2: float,
                                 bits: int, d: int, *, weight_decay: float = 0.0) -> torch.Tensor:
    """The same step over a packed uint8 container ``[N, ceil(d*bits/8)]``:
    rows are unpacked, stepped as above and re-packed in place."""
    safe = _clamped(uniq, packed.shape[0])
    w_new, codes_rows, mu_rows, nu_rows = _row_step(
        unpack_codes(packed.index_select(0, safe), bits, d), step, mu, nu, safe, g_sum,
        noise, lr, c1, c2, bits, weight_decay)
    for t, rows in ((packed, pack_codes(codes_rows, bits)), (mu, mu_rows), (nu, nu_rows)):
        t.index_copy_(0, *in_range_rows(uniq, rows, t.shape[0]))
    return w_new


def _clamped(uniq: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(uniq.to(torch.int64), 0, n - 1)


def _row_step(codes_rows, step, mu, nu, safe, g_sum, noise, lr, c1, c2, bits, weight_decay):
    step_rows = step.index_select(0, safe)
    w_new, mu_rows, nu_rows = adam_row_step(
        codes_rows.to(torch.float32), step_rows, mu.index_select(0, safe),
        nu.index_select(0, safe), g_sum.to(torch.float32), lr, c1, c2, weight_decay)
    return w_new, sr_round_ref(w_new, step_rows, noise, bits), mu_rows, nu_rows


def adam_update_ref(params, grads, mu, nu, lr: float, bc1: float, bc2: float, *,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.0):
    """One AdamW step over lists of tensors -> ``(new_params, new_mu, new_nu)``,
    new tensors throughout.  ``lr``, ``bc1 = 1 - b1^t`` and ``bc2 = 1 - b2^t``
    are float32 values.

    The reference's ``optim/adam.py`` update as XLA:CPU compiles it inside
    the jitted train step: the moment updates and the parameter step are
    fused multiply-adds, and the quotient is ``m' / (bc1 * (sqrt(v' / bc2) +
    eps))``.
    """
    lr, bc1, bc2 = f32(lr), f32(bc1), f32(bc2)
    B1_, A1_, B2_, A2_ = f32(b1), f32(1.0 - b1), f32(b2), f32(1.0 - b2)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        g32 = g.to(torch.float32)
        m = fma(B1_, m, A1_ * g32)
        v = fma(B2_, v, A2_ * (g32 * g32))
        update = m / (bc1 * (sqrt_rn(v / scalar(bc2, v)) + f32(eps)))
        p32 = p.detach().to(torch.float32)
        if weight_decay:
            update = fma(f32(weight_decay), p32, update)
        new_p.append(fma(-lr, update, p32).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return new_p, new_m, new_v
