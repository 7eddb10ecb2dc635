"""Low-precision embedding tables (port of repro/core/lpt.py, init and lookup).

The table lives as integer codes plus a per-row step size Delta; there is no
full-precision master copy (paper §2.3).  This slice ports what serving
needs: building a table (:func:`init_table`, which quantizes the init with
stochastic rounding through the ``sr_round`` kernel) and reading rows
(:func:`lookup`).  ``sparse_apply`` / ``dense_apply`` come with training.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import quant
from repro_torch.core.codestore import CodeStore
from repro_torch.kernels import ops


class LPTTable(NamedTuple):
    """Quantized embedding table + per-row step + row optimizer state."""

    codes: CodeStore  # packed uint8 at bits in {2, 4}, int8 otherwise
    step: torch.Tensor  # f32 [n] (feature-wise Delta; ALPT learns it)
    mu: torch.Tensor  # f32 [n, d] (adam) | [n] zeros (adagrad/sgd)
    nu: torch.Tensor  # f32 [n, d] (adam) | [n] (adagrad accumulator) | [n] zeros
    count: int  # global step for Adam bias correction

    @property
    def n_rows(self) -> int:
        return self.codes.shape[0]

    @property
    def dim(self) -> int:
        return self.codes.shape[1]


def init_table(generator: torch.Generator, n: int, d: int, bits: int, *,
               init_scale: float = 1e-2, mean: float = 0.0,
               step_size: float | None = None, clip_value: float | None = None,
               optimizer: str = "adam", use_kernels: bool = False,
               packed: bool | None = None) -> LPTTable:
    """Weights ~ N(mean, init_scale^2) and SR noise from ``generator`` (on its
    device), then :func:`table_from_init`.  The draws differ from JAX's
    threefry stream; parity tests call :func:`table_from_init` with JAX's."""
    w = torch.randn((n, d), generator=generator, dtype=torch.float32,
                    device=generator.device) * init_scale
    if mean:
        w = mean + w
    noise = quant.sr_noise(generator, (n, d))
    return table_from_init(w, noise, bits, step_size=step_size, clip_value=clip_value,
                           optimizer=optimizer, use_kernels=use_kernels, packed=packed)


def table_from_init(w: torch.Tensor, noise: torch.Tensor, bits: int, *,
                    step_size: float | None = None, clip_value: float | None = None,
                    optimizer: str = "adam", use_kernels: bool = False,
                    packed: bool | None = None) -> LPTTable:
    """Choose Delta, SR-quantize ``w`` with ``noise``, store the codes.

    Vanilla LPT fixes Delta from a tuned clip value (clip / 2^{m-1}); with
    neither ``step_size`` nor ``clip_value``, Delta is set per row LSQ-style
    from ``w`` (the ALPT default).  ``packed`` selects the container: None or
    True packs bits in {2, 4}, False keeps one byte per code.
    """
    n, d = w.shape
    if step_size is not None:
        step = torch.full((n,), step_size, dtype=torch.float32, device=w.device)
    elif clip_value is not None:
        step = torch.full((n,), clip_value / (2 ** (bits - 1)), dtype=torch.float32,
                          device=w.device)
    else:
        step = quant.init_step_size(w, bits, per_row=True)
    if use_kernels:
        codes = ops.sr_round(w, step, noise, bits)
    else:
        codes = quant.quantize_codes(w, step, bits, "sr", noise)
    codes = CodeStore.from_codes(codes, bits, packed=packed)
    if optimizer == "adam":
        slot_shape = (n, d)
    elif optimizer in ("adagrad", "sgd"):
        slot_shape = (n,)
    else:
        raise ValueError(f"unknown row optimizer {optimizer!r}")
    mu = torch.zeros(slot_shape, dtype=torch.float32, device=w.device)
    nu = torch.zeros(slot_shape, dtype=torch.float32, device=w.device)
    return LPTTable(codes=codes, step=step, mu=mu, nu=nu, count=0)


def lookup(table: LPTTable, ids: torch.Tensor, *, use_kernels: bool = False,
           out_dim: int | None = None) -> torch.Tensor:
    """De-quantize the rows for int32 ``ids`` (any leading shape) -> f32 [..., d].

    ``use_kernels`` routes through the fused gather (``ops.dequant_gather``);
    the plain path is bitwise identical.  ``out_dim`` slices padded tables
    back to the live embedding width.
    """
    if use_kernels:
        rows = ops.dequant_gather(table.codes, table.step, ids.reshape(-1))
        rows = rows.reshape(*ids.shape, table.dim)
    else:
        rows = quant.dequantize(table.codes.take(ids), table.step[ids])
    if out_dim is not None and out_dim != rows.shape[-1]:
        rows = rows[..., :out_dim]
    return rows
