"""QR compositional embeddings (Shi et al. 2020; paper §4.1), port of
repro/core/hashing.py.

The n x d table is replaced by a remainder table E1 in R^{r x d} (indexed by
``id % r``) and a quotient table E2 in R^{ceil(n/r) x d} (indexed by
``id // r``), whose rows are multiplied element-wise.  r is chosen so that
``r + n/r ~= n / compression``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QRTable(NamedTuple):
    remainder: torch.Tensor  # f32 [r, d]
    quotient: torch.Tensor  # f32 [ceil(n/r), d]
    r: int


def qr_rows(n: int, compression: float = 2.0) -> tuple[int, int]:
    """(remainder rows r, quotient rows ceil(n/r)) such that
    (r + n/r) ~= n / compression (quadratic formula).  Plain Python math: the
    sub-table geometry depends on it."""
    target = n / compression
    # r + n/r = target  ->  r^2 - target*r + n = 0
    disc = target * target - 4.0 * n
    if disc <= 0:
        r = max(int(n ** 0.5), 2)
    else:
        r = int((target - disc**0.5) / 2.0)
        r = max(r, 2)
    return r, -(-n // r)  # ceil


def init_qr(generator: torch.Generator, n: int, d: int, *, compression: float = 2.0,
            init_scale: float = 1e-2) -> QRTable:
    """Remainder rows ~ N(0, init_scale^2), quotient rows ~ N(1, init_scale^2)
    (so the product starts ~= the remainder rows), on ``generator.device``."""
    r, q_rows = qr_rows(n, compression)
    dev = generator.device
    rem = torch.randn((r, d), generator=generator, dtype=torch.float32, device=dev) * init_scale
    quo = 1.0 + torch.randn((q_rows, d), generator=generator, dtype=torch.float32,
                            device=dev) * init_scale
    return QRTable(remainder=rem, quotient=quo, r=r)


def qr_lookup(table: QRTable, ids: torch.Tensor) -> torch.Tensor:
    ids = ids.to(torch.int64)
    return table.remainder[ids % table.r] * table.quotient[ids // table.r]


def qr_params(table: QRTable) -> dict:
    """The trainable leaves (r is static)."""
    return {"remainder": table.remainder, "quotient": table.quotient}


def qr_memory_bytes(table: QRTable) -> int:
    return int((table.remainder.numel() + table.quotient.numel()) * 4)
