"""Serving-resident embedding tables (port of repro/serving/table.py).

* :class:`QuantTable` — codes (int8, or packed 2/4-bit) + per-row Delta.
  Rows are read through ``ops.dequant_gather``; the fp32 table never exists.
* :class:`FloatTable` — the fp32 export of float-leaf methods (``fp``).

``head_logits`` (the tied LM head through ``dequant_matmul``) comes with the
LM slice.
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
        out = ops.dequant_gather(self.codes, self.step, ids.reshape(-1),
                                 use_kernel=self.use_kernels)
        out = out.reshape(*ids.shape, self.codes.d)
        if self.d != out.shape[-1]:
            out = out[..., : self.d]
        return out

    def code_bytes(self) -> int:
        return self.codes.resident_bytes

    def scale_bytes(self) -> int:
        return self.step.numel() * self.step.element_size()

    def live_rows(self) -> int:
        return self.n

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.codes.data, self.step)


ServingTable = FloatTable | QuantTable


def is_integer_resident(table: ServingTable) -> bool:
    """True when the resident bytes are integer codes (+ scales), not fp32."""
    return isinstance(table, QuantTable)


def resident_bytes(table: ServingTable) -> int:
    """Bytes the table keeps resident, summed over its tensors."""
    return sum(t.numel() * t.element_size() for t in table.tensors())
