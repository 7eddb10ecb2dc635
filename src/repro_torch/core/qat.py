"""QAT baselines (paper §2.2 / §4.1): LSQ and PACT, port of repro/core/qat.py.

Unlike LPT these keep a full-precision master copy of the embedding table,
so they compress inference (4x at int8) but not training memory (1x), the
distinction Table 1's "Compression ratio" columns draw.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import quant


class QATTable(NamedTuple):
    weights: torch.Tensor  # f32 [n, d]: the master copy (what LPT removes)
    scale: torch.Tensor  # f32 [n]: LSQ step size or PACT clip alpha


def table_from_weights(w: torch.Tensor, bits: int, *, method: str = "lsq") -> QATTable:
    """The QAT state over weights ``w``: the LSQ-style per-row step, or for
    PACT alpha = step * (2^{m-1} - 1)."""
    if method == "lsq":
        scale = quant.init_step_size(w, bits, per_row=True)
    elif method == "pact":
        p = 2 ** (bits - 1) - 1
        scale = quant.init_step_size(w, bits, per_row=True) * p
    else:
        raise ValueError(f"unknown QAT method {method!r}")
    return QATTable(weights=w, scale=scale)


def init_qat(generator: torch.Generator, n: int, d: int, bits: int, *, method: str = "lsq",
             init_scale: float = 1e-2) -> QATTable:
    w = torch.randn((n, d), generator=generator, dtype=torch.float32,
                    device=generator.device) * init_scale
    return table_from_weights(w, bits, method=method)


def qat_lookup(table: QATTable, ids: torch.Tensor, bits: int, *, method: str = "lsq",
               grad_scale: float = 1.0) -> torch.Tensor:
    """Fake-quantized lookup: forward sees Q_D(w), backward flows STE to the
    master weights and (Eq. 7 / the PACT rule) to the scale."""
    w_rows = table.weights[ids]
    s_rows = table.scale[ids]
    if method == "lsq":
        return quant.fake_quant_lsq(w_rows, s_rows, bits, grad_scale)
    return quant.fake_quant_pact(w_rows, s_rows, bits)


def export_int8(table: QATTable, bits: int, *, method: str = "lsq"):
    """Post-training export: integer codes (rounded with DR) + per-row step."""
    if method == "pact":
        p = 2 ** (bits - 1) - 1
        step = table.scale / p
    else:
        step = table.scale
    codes = quant.quantize_codes(table.weights, step, bits, "dr")
    return codes, step
