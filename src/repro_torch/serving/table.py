"""Serving-resident embedding tables (port of repro/serving/table.py).

* :class:`QuantTable` — codes (int8, or packed 2/4-bit) + per-row Delta.
  Rows are read through ``ops.dequant_gather`` and the tied LM head
  contracts through ``ops.dequant_matmul``; the fp32 table never exists.
* :class:`FloatTable` — the fp32 export of float-leaf methods (``fp``).

The module-level :func:`rows` and :func:`head_logits` also take a raw fp32
[n, d] tensor (an untied head, a float table), as the reference's do.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.codestore import CodeStore
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class FloatTable:
    """fp32-resident [n, d] table (float-leaf methods' serving export)."""

    table: torch.Tensor

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        return self.table[ids]

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        return _matmul_head(self.table, h)

    def code_bytes(self) -> int:
        return 0

    def scale_bytes(self) -> int:
        return 0

    def live_rows(self) -> int:
        return int(self.table.shape[0])

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.table,)


@dataclasses.dataclass(frozen=True)
class QuantTable:
    """Integer-resident table: codes [N, D] + per-row scale [N].

    ``n``/``d`` are the live geometry; with ``pad_to_tiles`` the allocation
    is larger and reads are sliced back to ``d``.
    """

    codes: CodeStore
    step: torch.Tensor  # f32 [N_alloc]
    n: int  # live id space (ids must be < n)
    d: int  # live embedding width
    use_kernels: bool = True

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        # The gather kernel takes int32 ids (token ids may arrive as int64).
        out = ops.dequant_gather(self.codes, self.step, ids.reshape(-1).to(torch.int32),
                                 use_kernel=self.use_kernels)
        out = out.reshape(*ids.shape, self.codes.d)
        if self.d != out.shape[-1]:
            out = out[..., : self.d]
        return out

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        """Tied-head logits ``h [..., d] -> [..., n]`` (f32) through
        ``ops.dequant_matmul``; padded columns (``d_alloc > d``) meet zero
        activations, so the contraction is exact over the live width."""
        lead = h.shape[:-1]
        h2 = h.reshape(-1, h.shape[-1]).to(torch.float32)
        d_alloc = self.codes.d
        if h2.shape[-1] != d_alloc:
            h2 = torch.nn.functional.pad(h2, (0, d_alloc - h2.shape[-1]))
        logits = ops.dequant_matmul(h2.contiguous(), self.codes, self.step,
                                    use_kernel=self.use_kernels)
        if self.n != logits.shape[-1]:
            logits = logits[:, : self.n]
        return logits.reshape(*lead, self.n)

    def code_bytes(self) -> int:
        return self.codes.resident_bytes

    def scale_bytes(self) -> int:
        return self.step.numel() * self.step.element_size()

    def live_rows(self) -> int:
        return self.n

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.codes.data, self.step)


ServingTable = FloatTable | QuantTable


def _matmul_head(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The reference head over a dense fp table: ``einsum('...d,vd->...v')``."""
    return h.to(torch.float32) @ w.to(torch.float32).T


def is_serving_table(table) -> bool:
    return isinstance(table, (FloatTable, QuantTable))


def rows(table, ids: torch.Tensor) -> torch.Tensor:
    """De-quantized rows for ``ids`` (any leading shape) -> f32 [..., d]."""
    if is_serving_table(table):
        return table.rows(ids)
    return table[ids]


def head_logits(table, h: torch.Tensor) -> torch.Tensor:
    """Head contraction ``h [..., d] -> logits [..., n]`` (f32): an
    int8-resident table through ``ops.dequant_matmul``, a float table or a
    raw [n, d] tensor as a plain matmul."""
    if is_serving_table(table):
        return table.head_logits(h)
    return _matmul_head(table, h)


def is_integer_resident(table: ServingTable) -> bool:
    """True when the resident bytes are integer codes (+ scales), not fp32."""
    return isinstance(table, QuantTable)


def resident_bytes(table: ServingTable) -> int:
    """Bytes the table keeps resident, summed over its tensors."""
    return sum(t.numel() * t.element_size() for t in table.tensors())
