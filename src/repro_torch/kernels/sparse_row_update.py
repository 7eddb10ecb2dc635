"""CUDA ``sparse_row_update`` / ``sparse_row_update_packed``: the fused CTR row step.

Port of ``repro/kernels/sparse_row_update.py:71`` and ``:139``; the kernels
are in ``csrc/sparse_row_update.cu``, whose header says what bounds them and
how they are built for that.  Per unique id: gather the row's codes and Adam
slots, de-quantize, Adam step, SR re-quantize, and write codes, ``mu`` and
``nu`` back **in place**; the updated float rows come back as ``w_new``
[K, d].  Bitwise equal to :func:`repro_torch.kernels.ref.sparse_row_update_ref`
and ``sparse_row_update_packed_ref`` on the same operands.

:func:`sparse_row_update_runs` and :func:`sparse_row_update_runs_packed` take
the per-lookup gradients and each slot's run of lookups in place of the
summed gradients, and sum each run in the kernel, in occurrence order: the
row step together with the reference's duplicate-id sum
(``repro/core/lpt.py:255``), bitwise equal to
:func:`repro_torch.kernels.ref.sparse_row_update_runs_ref` and its packed twin.
"""
from __future__ import annotations

import torch

from repro_torch.core.codestore import is_packable, packed_width
from repro_torch.kernels import _build, ref


def _launch(kernel: str, codes: torch.Tensor, step, mu, nu, uniq, g, noise, lr, c1, c2,
            *, d: int, container_bits: int, bits: int, weight_decay: float,
            runs: tuple | None = None) -> torch.Tensor:
    """Check the operands and launch one form: ``g`` is g_sum [k, d], or
    with ``runs = (order, starts)`` the per-lookup g_occ [m, d]."""
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
    _build.check_operand(kernel, "noise", noise, torch.float32, (k, d), dev)
    if runs is None:
        _build.check_operand(kernel, "g_sum", g, torch.float32, (k, d), dev)
    else:
        order, starts = runs
        if g.ndim != 2:
            raise ValueError(f"{kernel}: g_occ must be 2-D, got {tuple(g.shape)}")
        m = g.shape[0]
        _build.check_operand(kernel, "g_occ", g, torch.float32, (m, d), dev)
        _build.check_operand(kernel, "order", order, torch.int64, (m,), dev)
        _build.check_operand(kernel, "starts", starts, torch.int32, (k + 1,), dev)
    w_new = torch.empty((k, d), dtype=torch.float32, device=dev)
    if w_new.numel() == 0:
        return w_new
    f = ref.f32
    scalars = (container_bits, bits, f(lr), f(c1), f(c2), ref.B1, ref.A1, ref.B2, ref.A2,
               ref.EPS, f(weight_decay), _build.stream_of(dev))
    with _build.on_device(dev):
        if runs is None:
            _build.launch(
                kernel, "sparse_row_update", "sparse_row_update_launch",
                codes.data_ptr(), step.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                uniq.data_ptr(), g.data_ptr(), noise.data_ptr(), w_new.data_ptr(), n, d, k,
                width, *scalars)
        else:
            _build.launch(
                kernel, "sparse_row_update", "sparse_row_update_runs_launch",
                codes.data_ptr(), step.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                uniq.data_ptr(), g.data_ptr(), order.data_ptr(), starts.data_ptr(),
                noise.data_ptr(), w_new.data_ptr(), n, d, k, m, width, *scalars)
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


def sparse_row_update_runs(codes: torch.Tensor, step: torch.Tensor, mu: torch.Tensor,
                           nu: torch.Tensor, uniq: torch.Tensor, g_occ: torch.Tensor,
                           order: torch.Tensor, starts: torch.Tensor, noise: torch.Tensor,
                           lr: float, c1: float, c2: float, bits: int, *,
                           weight_decay: float = 0.0) -> torch.Tensor:
    """:func:`sparse_row_update` with slot s's gradient summed in the kernel:
    ``g_occ`` f32 [m, d] per lookup, ``order`` int64 [m] (the lookups grouped
    by slot, in occurrence order within a slot) and ``starts`` int32 [k + 1]
    (slot s's run is ``order[starts[s]:starts[s + 1]]``), as
    :func:`repro_torch.core.lpt.dedup_runs` makes them."""
    d = codes.shape[-1] if codes.ndim == 2 else 0
    return _launch("sparse_row_update_runs", codes, step, mu, nu, uniq, g_occ, noise, lr, c1,
                   c2, d=d, container_bits=8, bits=bits, weight_decay=weight_decay,
                   runs=(order, starts))


def sparse_row_update_runs_packed(packed: torch.Tensor, step: torch.Tensor, mu: torch.Tensor,
                                  nu: torch.Tensor, uniq: torch.Tensor, g_occ: torch.Tensor,
                                  order: torch.Tensor, starts: torch.Tensor,
                                  noise: torch.Tensor, lr: float, c1: float, c2: float,
                                  bits: int, d: int, *,
                                  weight_decay: float = 0.0) -> torch.Tensor:
    """:func:`sparse_row_update_runs` over packed uint8 rows, bits 2 or 4."""
    if not is_packable(bits):
        raise ValueError(f"sparse_row_update_runs_packed: bits must be 2 or 4, got {bits}")
    return _launch("sparse_row_update_runs_packed", packed, step, mu, nu, uniq, g_occ, noise,
                   lr, c1, c2, d=d, container_bits=bits, bits=bits, weight_decay=weight_decay,
                   runs=(order, starts))
