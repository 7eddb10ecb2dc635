"""Serving-resident embedding tables (port of repro/serving/table.py).

* :class:`QuantTable` — codes (int8, or packed 2/4-bit) + per-row Delta.
  Rows are read through ``ops.dequant_gather`` and the tied LM head
  contracts through ``ops.dequant_matmul``; the fp32 table never exists.
* :class:`QRQuantTable` — qr_lpt / qr_alpt: two ``QuantTable`` factors,
  virtual row ``i`` = ``remainder[i % r] * quotient[i // r]``.
* :class:`MixedQuantTable` — mixed: one ``QuantTable`` per bit-width group
  and the static field maps that route a global id to its group's row.
* :class:`FloatTable` — the fp32 export of float-leaf methods (fp, hash,
  prune; lsq and pact serve their int8 export as a ``QuantTable``).

The module-level :func:`rows` and :func:`head_logits` also take a raw fp32
[n, d] tensor (an untied head, a float table), as the reference's do.

Each table names its children for a checkpoint as the reference's pytree
registry does (``tree_children``: tensors, a ``CodeStore``, sub-tables), and
``from_tree`` reads a restored node into a template of the same config
(static fields kept, leaves replaced).

``cache_slots()`` names the tables a hot-row cache can wrap (one per
``QuantTable``; none in a ``FloatTable``): a ``QuantTable``'s codes may then
be a :class:`repro_torch.core.tiered.TieredCodes`, read through the
routed gathers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.codestore import CodeStore
from repro_torch.core.tiered import TieredCodes
from repro_torch.kernels import ops
from repro_torch.storage.base import CacheSlot


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

    def tree_children(self) -> tuple:
        return (self.table,)

    def from_tree(self, node, *, use_kernels: bool) -> "FloatTable":
        return FloatTable(node[0])

    def cache_slots(self) -> tuple[CacheSlot, ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class QuantTable:
    """Integer-resident table: codes [N, D] + per-row scale [N].

    ``n``/``d`` are the live geometry; with ``pad_to_tiles`` the allocation
    is larger and reads are sliced back to ``d``.
    """

    codes: CodeStore | TieredCodes
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
        return (*self.codes.tensors(), self.step)

    def tree_children(self) -> tuple:
        return (self.codes, self.step)

    def from_tree(self, node, *, use_kernels: bool) -> "QuantTable":
        codes, step = node
        return dataclasses.replace(self, codes=dataclasses.replace(self.codes, data=codes["data"]),
                                   step=step, use_kernels=use_kernels)

    def cache_slots(self) -> tuple[CacheSlot, ...]:
        return (CacheSlot(name="table", rows=self.n, get=lambda t: t, put=lambda t, sub: sub,
                          local_ids=np.asarray),)


@dataclasses.dataclass(frozen=True)
class QRQuantTable:
    """Quotient-remainder composition of two integer-resident sub-tables:
    virtual row ``i`` is ``remainder[i % r] * quotient[i // r]``, each factor
    with its own learned per-row Delta."""

    remainder: QuantTable
    quotient: QuantTable
    r: int  # remainder modulus
    n: int
    d: int

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        return self.remainder.rows(ids % self.r) * self.quotient.rows(
            torch.div(ids, self.r, rounding_mode="floor"))

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        # The product head is not one matmul over codes: the virtual rows
        # are composed from the two gathers (a transient [n, d]).
        ids = torch.arange(self.n, dtype=torch.int32, device=h.device)
        return _matmul_head(self.rows(ids), h)

    def code_bytes(self) -> int:
        return self.remainder.code_bytes() + self.quotient.code_bytes()

    def scale_bytes(self) -> int:
        return self.remainder.scale_bytes() + self.quotient.scale_bytes()

    def live_rows(self) -> int:
        return self.n

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return self.remainder.tensors() + self.quotient.tensors()

    def tree_children(self) -> tuple:
        return (self.remainder, self.quotient)

    def from_tree(self, node, *, use_kernels: bool) -> "QRQuantTable":
        return dataclasses.replace(
            self, remainder=self.remainder.from_tree(node[0], use_kernels=use_kernels),
            quotient=self.quotient.from_tree(node[1], use_kernels=use_kernels))

    def cache_slots(self) -> tuple[CacheSlot, ...]:
        r = self.r
        return (
            CacheSlot(name="remainder", rows=self.remainder.n, get=lambda t: t.remainder,
                      put=lambda t, sub: dataclasses.replace(t, remainder=sub),
                      local_ids=lambda ids: np.asarray(ids) % r),
            CacheSlot(name="quotient", rows=self.quotient.n, get=lambda t: t.quotient,
                      put=lambda t, sub: dataclasses.replace(t, quotient=sub),
                      local_ids=lambda ids: np.asarray(ids) // r),
        )


def map_field_ids(field_offsets, field_group, field_local, ids: torch.Tensor):
    """Global ids -> (group index, local row), both int32, through a per-field
    composition's static maps (``searchsorted`` over the fields' start rows)."""
    dev = ids.device
    offs = torch.tensor(field_offsets, dtype=torch.int64, device=dev)
    ids64 = ids.to(torch.int64)
    fid = torch.searchsorted(offs, ids64, right=True) - 1
    local = ids64 - offs[fid] + torch.tensor(field_local, dtype=torch.int64, device=dev)[fid]
    gid = torch.tensor(field_group, dtype=torch.int64, device=dev)[fid]
    return gid.to(torch.int32), local.to(torch.int32)


def group_slots(field_offsets, field_group, field_local, group_rows, *, get,
                put) -> tuple[CacheSlot, ...]:
    """One :class:`CacheSlot` per bit-width group of a per-field composition
    (``get(state, g)``, ``put(state, g, sub)``): a global id maps through the
    field maps to its group's local row, and to -1 in every other group."""
    starts = np.asarray(field_offsets, np.int64)
    group = np.asarray(field_group, np.int64)
    local = np.asarray(field_local, np.int64)

    def local_ids(g):
        def f(ids):
            ids = np.asarray(ids, np.int64)
            fid = np.searchsorted(starts, ids, side="right") - 1
            return np.where(group[fid] == g, ids - starts[fid] + local[fid], -1)
        return f

    return tuple(CacheSlot(name=f"group{g}", rows=int(rows), get=lambda s, g=g: get(s, g),
                           put=lambda s, t, g=g: put(s, g, t), local_ids=local_ids(g))
                 for g, rows in enumerate(group_rows))


def masked_sum(gid: torch.Tensor, local: torch.Tensor, d: int, reads) -> torch.Tensor:
    """``sum_g where(gid == g, reads[g](where(gid == g, local, 0)), 0)`` over
    the groups in order, from zeros: the composition the mixed method's
    training lookup and :class:`MixedQuantTable` share, so they agree bit
    for bit."""
    out = torch.zeros((*gid.shape, d), dtype=torch.float32, device=gid.device)
    for g, read in enumerate(reads):
        mask = gid == g
        out = out + torch.where(mask[..., None], read(torch.where(mask, local, 0)), 0.0)
    return out


@dataclasses.dataclass(frozen=True)
class MixedQuantTable:
    """Per-field mixed-precision composition of integer-resident sub-tables:
    global id ``i`` of field ``f`` (``field_offsets``) is row ``i -
    field_offsets[f] + field_local[f]`` of sub-table ``field_group[f]``."""

    subs: tuple[QuantTable, ...]
    field_offsets: tuple[int, ...]  # [F] global start row per field
    field_group: tuple[int, ...]  # [F] sub-table index per field
    field_local: tuple[int, ...]  # [F] local start row inside the sub
    n: int
    d: int

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        gid, local = map_field_ids(self.field_offsets, self.field_group, self.field_local, ids)
        return masked_sum(gid, local, self.d, [sub.rows for sub in self.subs])

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        ids = torch.arange(self.n, dtype=torch.int32, device=h.device)
        return _matmul_head(self.rows(ids), h)

    def code_bytes(self) -> int:
        return sum(sub.code_bytes() for sub in self.subs)

    def scale_bytes(self) -> int:
        return sum(sub.scale_bytes() for sub in self.subs)

    def live_rows(self) -> int:
        return self.n

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(t for sub in self.subs for t in sub.tensors())

    def tree_children(self) -> tuple:
        return (self.subs,)

    def from_tree(self, node, *, use_kernels: bool) -> "MixedQuantTable":
        subs = tuple(sub.from_tree(child, use_kernels=use_kernels)
                     for sub, child in zip(self.subs, node[0]))
        return dataclasses.replace(self, subs=subs)

    def cache_slots(self) -> tuple[CacheSlot, ...]:
        return group_slots(
            self.field_offsets, self.field_group, self.field_local,
            [sub.n for sub in self.subs], get=lambda t, g: t.subs[g],
            put=lambda t, g, sub: dataclasses.replace(
                t, subs=t.subs[:g] + (sub,) + t.subs[g + 1:]))


ServingTable = FloatTable | QuantTable | QRQuantTable | MixedQuantTable


def _matmul_head(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The reference head over a dense fp table: ``einsum('...d,vd->...v')``."""
    return h.to(torch.float32) @ w.to(torch.float32).T


def is_serving_table(table) -> bool:
    return isinstance(table, (FloatTable, QuantTable, QRQuantTable, MixedQuantTable))


def cache_slots(table) -> tuple[CacheSlot, ...]:
    """The cacheable :class:`QuantTable` slots inside a serving table."""
    return table.cache_slots() if is_serving_table(table) else ()


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
    return isinstance(table, (QuantTable, QRQuantTable, MixedQuantTable))


def resident_bytes(table: ServingTable) -> int:
    """Bytes the table keeps resident, summed over its tensors."""
    return sum(t.numel() * t.element_size() for t in table.tensors())

