"""CUDA ``lpt_fused_update`` / ``lpt_fused_update_packed``: the dense LPT write-back.

Port of ``repro/kernels/lpt_update.py:50`` and ``:93``; the kernels are in
``csrc/lpt_update.cu``, whose header says what bounds them and how they are
built for that.  Per element of the table: de-quantize, take the (decayed)
step along the formed optimizer direction, SR re-quantize with the new step
(ALPT's Delta') or the old one; the fp32 table never exists.  Bitwise equal
to :func:`repro_torch.kernels.ref.lpt_fused_update_ref` and
``lpt_fused_update_packed_ref`` on the same operands.
"""
from __future__ import annotations

import torch

from repro_torch.core.codestore import is_packable, packed_width
from repro_torch.kernels import _build, ref


def _launch(kernel: str, codes: torch.Tensor, step, upd, noise, lr, *, bits: int, d: int,
            container_bits: int, new_step, weight_decay: float) -> torch.Tensor:
    if not 2 <= bits <= 8:
        raise ValueError(f"{kernel}: bits must be in [2, 8], got {bits}")
    if codes.ndim != 2:
        raise ValueError(f"{kernel}: codes must be 2-D, got shape {tuple(codes.shape)}")
    rows, width = codes.shape
    dev = codes.device
    container = torch.int8 if container_bits == 8 else torch.uint8
    _build.check_operand(kernel, "codes", codes, container,
                         (rows, d if container_bits == 8 else packed_width(d, container_bits)))
    _build.check_operand(kernel, "step", step, torch.float32, (rows,), dev)
    if new_step is None:
        new_step = step
    _build.check_operand(kernel, "new_step", new_step, torch.float32, (rows,), dev)
    _build.check_operand(kernel, "upd", upd, torch.float32, (rows, d), dev)
    _build.check_operand(kernel, "noise", noise, torch.float32, (rows, d), dev)
    out = torch.empty_like(codes)
    if rows * d == 0:
        return out
    with _build.on_device(dev):
        _build.launch(
            kernel, "lpt_update", "lpt_update_launch",
            codes.data_ptr(), step.data_ptr(), new_step.data_ptr(), upd.data_ptr(),
            noise.data_ptr(), out.data_ptr(), rows, d, width, container_bits, bits,
            ref.f32(lr), ref.f32(weight_decay), _build.stream_of(dev),
        )
    return out


def lpt_fused_update(codes: torch.Tensor, step: torch.Tensor, upd: torch.Tensor,
                     noise: torch.Tensor, lr: float, bits: int, *,
                     new_step: torch.Tensor | None = None,
                     weight_decay: float = 0.0) -> torch.Tensor:
    """New int8 codes [r, c] from int8 ``codes`` [r, c], ``step`` f32 [r], the
    direction ``upd`` and ``noise`` f32 [r, c] and ``new_step`` f32 [r]
    (default ``step``), all contiguous on one CUDA device; ``lr`` and
    ``weight_decay`` are float32 values (host scalars, passed by value)."""
    d = codes.shape[-1] if codes.ndim == 2 else 0
    return _launch("lpt_fused_update", codes, step, upd, noise, lr, bits=bits, d=d,
                   container_bits=8, new_step=new_step, weight_decay=weight_decay)


def lpt_fused_update_packed(packed: torch.Tensor, step: torch.Tensor, upd: torch.Tensor,
                            noise: torch.Tensor, lr: float, bits: int, d: int, *,
                            new_step: torch.Tensor | None = None,
                            weight_decay: float = 0.0) -> torch.Tensor:
    """The same write-back over packed uint8 rows [r, ceil(d*bits/8)], bits 2
    or 4, returning new packed bytes: unpacked and sign-extended in
    registers, re-packed low bits first."""
    if not is_packable(bits):
        raise ValueError(f"lpt_fused_update_packed: bits must be 2 or 4, got {bits}")
    return _launch("lpt_fused_update_packed", packed, step, upd, noise, lr, bits=bits, d=d,
                   container_bits=bits, new_step=new_step, weight_decay=weight_decay)
