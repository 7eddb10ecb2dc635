"""CUDA ``dequant_matmul`` / ``dequant_matmul_packed``: the quantized LM head.

Port of ``repro/kernels/dequant_matmul.py:49`` and ``:99``; the kernels are
in ``csrc/dequant_matmul.cu``, whose header says what bounds them and how
they are built for that.  ``y = x @ (step[:, None] * codes).T`` in fp32 with
the codes de-quantized on chip: the fp32 [N, K] table never exists in device
memory.  Every M, N and K is taken (the reference's TPU kernel needs them to
divide its blocks).  The products run on the tensor cores as 2xTF32 (x split
into TF32 hi + lo; codes are exact in TF32) with Δ applied once to each
finished sum, in a k order that depends on K alone, so a row's logits do not
depend on the other rows of ``x``, and the packed kernel equals the int8
kernel on the unpacked codes bitwise.  Against the plain versions in
:mod:`repro_torch.kernels.ref` (a cuBLAS matmul over the de-quantized table)
they agree within the fp32 error of a K-term sum
(``tests/test_torch_head_tf32x2.py`` models the arithmetic on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.core.codestore import is_packable, packed_width
from repro_torch.kernels import _build


def _launch(kernel: str, x: torch.Tensor, codes: torch.Tensor, step: torch.Tensor,
            bits: int) -> torch.Tensor:
    m = x.shape[0]
    n = codes.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with _build.on_device(x.device):
        _build.launch(
            kernel, "dequant_matmul", "dequant_matmul_launch",
            x.data_ptr(), codes.data_ptr(), step.data_ptr(), out.data_ptr(),
            m, n, x.shape[1], bits, _build.stream_of(x.device),
        )
    return out


def _check_x(kernel: str, x: torch.Tensor, k: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"{kernel}: x must be 2-D [M, K], got shape {tuple(x.shape)}")
    _build.check_operand(kernel, "x", x, torch.float32, (x.shape[0], k))


def dequant_matmul(x: torch.Tensor, codes: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """f32 [M, N] ``x @ (step[:, None] * codes).T`` from f32 ``x`` [M, K],
    int8 ``codes`` [N, K] and f32 ``step`` [N] on one CUDA device."""
    if codes.ndim != 2:
        raise ValueError(f"dequant_matmul: codes must be 2-D, got {tuple(codes.shape)}")
    n, k = codes.shape
    _check_x("dequant_matmul", x, k)
    _build.check_operand("dequant_matmul", "codes", codes, torch.int8, (n, k), x.device)
    _build.check_operand("dequant_matmul", "step", step, torch.float32, (n,), x.device)
    return _launch("dequant_matmul", x, codes, step, 8)


def dequant_matmul_packed(x: torch.Tensor, packed: torch.Tensor, step: torch.Tensor, *,
                          bits: int, k: int) -> torch.Tensor:
    """The same head over packed uint8 rows [N, ceil(K*bits/8)], bits 2 or 4;
    the codes are unpacked and sign-extended in registers."""
    if not is_packable(bits):
        raise ValueError(f"dequant_matmul_packed: bits must be 2 or 4, got {bits}")
    if packed.ndim != 2:
        raise ValueError(f"dequant_matmul_packed: packed must be 2-D, got {tuple(packed.shape)}")
    n = packed.shape[0]
    _check_x("dequant_matmul_packed", x, k)
    _build.check_operand("dequant_matmul_packed", "packed", packed, torch.uint8,
                         (n, packed_width(k, bits)), x.device)
    _build.check_operand("dequant_matmul_packed", "step", step, torch.float32, (n,), x.device)
    return _launch("dequant_matmul_packed", x, packed, step, bits)
