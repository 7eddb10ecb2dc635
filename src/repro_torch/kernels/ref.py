"""Plain PyTorch versions of the port's kernels (port of repro/kernels/ref.py).

Each function repeats its kernel's arithmetic in the same operation order as
the reference's jnp oracle, so the CUDA kernel, this version and the JAX
package agree bitwise on the same operands.  :mod:`repro_torch.kernels.ops`
runs these for tensors on the CPU; ``chip_smoke.py`` holds each kernel
against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.codestore import unpack_codes


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
