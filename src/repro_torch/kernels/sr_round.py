"""CUDA ``sr_round``: fused clip + stochastic round + int8 store (Eq. 1/4).

Port of ``repro/kernels/sr_round.py:58`` (``sr_round``); the kernel is
``csrc/sr_round.cu``, whose header says what bounds it and how it is built
for that.  The noise ``u`` stays an operand, so the kernel is bitwise equal
to :func:`repro_torch.kernels.ref.sr_round_ref` on the same inputs.

``sr_round_seeded`` (port of ``:87``, the same source) draws the noise in
the kernel from Philox4x32-10 keyed by an int32 seed, so the noise operand's
bytes are never read; it is bitwise equal to
:func:`repro_torch.kernels.ref.sr_round_seeded_ref`, which computes the same
Philox words in PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def sr_round(w: torch.Tensor, step: torch.Tensor, noise: torch.Tensor,
             bits: int) -> torch.Tensor:
    """Codes int8 [r, c] from f32 ``w`` [r, c], per-row ``step`` [r] and
    uniform ``noise`` [r, c], all contiguous on one CUDA device."""
    if not 2 <= bits <= 8:
        raise ValueError(f"sr_round: bits must be in [2, 8], got {bits}")
    if w.ndim != 2:
        raise ValueError(f"sr_round: w must be 2-D, got shape {tuple(w.shape)}")
    rows, cols = w.shape
    _build.check_operand("sr_round", "w", w, torch.float32, (rows, cols))
    _build.check_operand("sr_round", "step", step, torch.float32, (rows,), w.device)
    _build.check_operand("sr_round", "noise", noise, torch.float32, (rows, cols), w.device)
    out = torch.empty((rows, cols), dtype=torch.int8, device=w.device)
    if out.numel() == 0:
        return out
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    with _build.on_device(w.device):
        _build.launch(
            "sr_round", "sr_round", "sr_round_launch",
            w.data_ptr(), step.data_ptr(), noise.data_ptr(), out.data_ptr(),
            rows, cols, lo, hi, _build.stream_of(w.device),
        )
    return out


def sr_round_seeded(w: torch.Tensor, step: torch.Tensor, seed: int, bits: int) -> torch.Tensor:
    """Codes int8 [r, c] from f32 ``w`` [r, c] and ``step`` [r] (contiguous,
    one CUDA device), the uniforms drawn in the kernel from ``seed``, an int32
    value (its bits, as uint32, key the generator)."""
    if not 2 <= bits <= 8:
        raise ValueError(f"sr_round_seeded: bits must be in [2, 8], got {bits}")
    if w.ndim != 2:
        raise ValueError(f"sr_round_seeded: w must be 2-D, got shape {tuple(w.shape)}")
    if not -(2 ** 31) <= int(seed) < 2 ** 31:
        raise ValueError(f"sr_round_seeded: seed must be an int32 value, got {seed}")
    rows, cols = w.shape
    _build.check_operand("sr_round_seeded", "w", w, torch.float32, (rows, cols))
    _build.check_operand("sr_round_seeded", "step", step, torch.float32, (rows,), w.device)
    out = torch.empty((rows, cols), dtype=torch.int8, device=w.device)
    if out.numel() == 0:
        return out
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    with _build.on_device(w.device):
        _build.launch(
            "sr_round_seeded", "sr_round", "sr_round_seeded_launch",
            w.data_ptr(), step.data_ptr(), out.data_ptr(), rows, cols, lo, hi,
            int(seed) & 0xFFFFFFFF, _build.stream_of(w.device),
        )
    return out
