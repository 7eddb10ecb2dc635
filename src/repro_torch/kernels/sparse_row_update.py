"""CUDA ``sparse_row_update`` / ``sparse_row_update_packed``: the fused CTR row step.

Port of ``repro/kernels/sparse_row_update.py:71`` and ``:139``; the kernels
are in ``csrc/sparse_row_update.cu``, whose header says what bounds them and
how they are built for that.  Per unique id: gather the row's codes and Adam
slots, de-quantize, Adam step, SR re-quantize, and write codes, ``mu`` and
``nu`` back **in place**; the updated float rows come back as ``w_new``
[K, d].  Bitwise equal to :func:`repro_torch.kernels.ref.sparse_row_update_ref`
and ``sparse_row_update_packed_ref`` on the same operands.
"""
from __future__ import annotations

import torch

from repro_torch.core.codestore import is_packable, packed_width
from repro_torch.kernels import _build, ref


def _launch(kernel: str, codes: torch.Tensor, step, mu, nu, uniq, g_sum, noise, lr, c1, c2,
            *, d: int, container_bits: int, bits: int, weight_decay: float) -> torch.Tensor:
    if not 2 <= bits <= 8:
        raise ValueError(f"{kernel}: bits must be in [2, 8], got {bits}")
    if codes.ndim != 2 or uniq.ndim != 1:
        raise ValueError(f"{kernel}: codes must be 2-D and uniq 1-D, got "
                         f"{tuple(codes.shape)} and {tuple(uniq.shape)}")
    n, width = codes.shape
    (k,) = uniq.shape
    dev = codes.device
    container = torch.int8 if container_bits == 8 else torch.uint8
    _build.check_operand(kernel, "codes", codes, container,
                         (n, d if container_bits == 8 else packed_width(d, container_bits)))
    _build.check_operand(kernel, "step", step, torch.float32, (n,), dev)
    _build.check_operand(kernel, "mu", mu, torch.float32, (n, d), dev)
    _build.check_operand(kernel, "nu", nu, torch.float32, (n, d), dev)
    _build.check_operand(kernel, "uniq", uniq, torch.int32, (k,), dev)
    _build.check_operand(kernel, "g_sum", g_sum, torch.float32, (k, d), dev)
    _build.check_operand(kernel, "noise", noise, torch.float32, (k, d), dev)
    w_new = torch.empty((k, d), dtype=torch.float32, device=dev)
    if w_new.numel() == 0:
        return w_new
    f = ref.f32
    with _build.on_device(dev):
        _build.launch(
            kernel, "sparse_row_update", "sparse_row_update_launch",
            codes.data_ptr(), step.data_ptr(), mu.data_ptr(), nu.data_ptr(), uniq.data_ptr(),
            g_sum.data_ptr(), noise.data_ptr(), w_new.data_ptr(), n, d, k, width,
            container_bits, bits, f(lr), f(c1), f(c2), ref.B1, ref.A1, ref.B2, ref.A2, ref.EPS,
            f(weight_decay), _build.stream_of(dev),
        )
    return w_new


def sparse_row_update(codes: torch.Tensor, step: torch.Tensor, mu: torch.Tensor,
                      nu: torch.Tensor, uniq: torch.Tensor, g_sum: torch.Tensor,
                      noise: torch.Tensor, lr: float, c1: float, c2: float, bits: int, *,
                      weight_decay: float = 0.0) -> torch.Tensor:
    """Row step over int8 ``codes`` [n, d]: ``step`` f32 [n], ``mu``/``nu`` f32
    [n, d], int32 ``uniq`` [k], ``g_sum``/``noise`` f32 [k, d], all contiguous
    on one CUDA device.  ``lr``, ``c1``, ``c2`` are float32 values (host
    scalars, passed by value).  Updates codes, mu, nu in place; returns
    ``w_new`` f32 [k, d]."""
    d = codes.shape[-1] if codes.ndim == 2 else 0
    return _launch("sparse_row_update", codes, step, mu, nu, uniq, g_sum, noise, lr, c1, c2,
                   d=d, container_bits=8, bits=bits, weight_decay=weight_decay)


def sparse_row_update_packed(packed: torch.Tensor, step: torch.Tensor, mu: torch.Tensor,
                             nu: torch.Tensor, uniq: torch.Tensor, g_sum: torch.Tensor,
                             noise: torch.Tensor, lr: float, c1: float, c2: float, bits: int,
                             d: int, *, weight_decay: float = 0.0) -> torch.Tensor:
    """The same step over packed uint8 rows [n, ceil(d*bits/8)], bits 2 or 4:
    unpacked and sign-extended in registers, re-packed low bits first."""
    if not is_packable(bits):
        raise ValueError(f"sparse_row_update_packed: bits must be 2 or 4, got {bits}")
    return _launch("sparse_row_update_packed", packed, step, mu, nu, uniq, g_sum, noise, lr,
                   c1, c2, d=d, container_bits=bits, bits=bits, weight_decay=weight_decay)
