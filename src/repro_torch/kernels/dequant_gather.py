"""CUDA ``dequant_gather`` / ``dequant_gather_packed``: fused row gather + dequantize.

Port of ``repro/kernels/dequant_gather.py:42`` and ``:78``; the kernels are
in ``csrc/dequant_gather.cu``, whose header says what bounds them and how
they are built for that.  Only the rows the ids select leave the integer
table: the fp32 table never exists.  Both are bitwise equal to the plain
versions in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core.codestore import is_packable, packed_width
from repro_torch.kernels import _build


def _check_ids(kernel: str, step: torch.Tensor, ids: torch.Tensor, n: int) -> None:
    _build.check_operand(kernel, "step", step, torch.float32, (n,))
    if ids.ndim != 1:
        raise ValueError(f"{kernel}: ids must be 1-D, got shape {tuple(ids.shape)}")
    _build.check_operand(kernel, "ids", ids, torch.int32, tuple(ids.shape), step.device)


def dequant_gather(codes: torch.Tensor, step: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """f32 [b, d] rows ``codes[ids] * step[ids]`` from int8 ``codes`` [n, d],
    f32 ``step`` [n] and int32 ``ids`` [b] on one CUDA device."""
    if codes.ndim != 2:
        raise ValueError(f"dequant_gather: codes must be 2-D, got {tuple(codes.shape)}")
    n, d = codes.shape
    _check_ids("dequant_gather", step, ids, n)
    _build.check_operand("dequant_gather", "codes", codes, torch.int8, (n, d), step.device)
    (b,) = ids.shape
    out = torch.empty((b, d), dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(codes.device):
        _build.launch(
            "dequant_gather", "dequant_gather", "dequant_gather_launch",
            codes.data_ptr(), step.data_ptr(), ids.data_ptr(), out.data_ptr(),
            n, d, b, _build.stream_of(codes.device),
        )
    return out


def dequant_gather_packed(packed: torch.Tensor, step: torch.Tensor, ids: torch.Tensor,
                          *, bits: int, d: int) -> torch.Tensor:
    """The same gather over packed uint8 rows [n, ceil(d*bits/8)], bits 2 or 4;
    the codes are unpacked and sign-extended in registers."""
    if not is_packable(bits):
        raise ValueError(f"dequant_gather_packed: bits must be 2 or 4, got {bits}")
    if packed.ndim != 2:
        raise ValueError(f"dequant_gather_packed: packed must be 2-D, got {tuple(packed.shape)}")
    n = packed.shape[0]
    _check_ids("dequant_gather_packed", step, ids, n)
    _build.check_operand("dequant_gather_packed", "packed", packed, torch.uint8,
                         (n, packed_width(d, bits)), step.device)
    (b,) = ids.shape
    out = torch.empty((b, d), dtype=torch.float32, device=packed.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(packed.device):
        _build.launch(
            "dequant_gather_packed", "dequant_gather", "dequant_gather_packed_launch",
            packed.data_ptr(), step.data_ptr(), ids.data_ptr(), out.data_ptr(),
            n, d, b, bits, _build.stream_of(packed.device),
        )
    return out
