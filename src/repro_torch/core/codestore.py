"""Packed storage for quantized embedding codes (port of repro/core/codestore.py).

    bits in {2, 4}   ->  packed uint8, ``8 // bits`` codes per byte
    bits in {5..8}   ->  one int8 byte per code

Packed layout (low-bits-first): logical code ``j`` of a row lives in byte
``j // cpb`` at bit offset ``(j % cpb) * bits`` where ``cpb = 8 // bits``.
Rows whose width is not a multiple of ``cpb`` are zero-padded to the next
byte; :func:`unpack_codes` slices the pad back off and sign-extends, so
pack/unpack are exact inverses on the signed code range and the bytes equal
the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

_PACKABLE_BITS = (2, 4)


def is_packable(bits: int) -> bool:
    """True when ``bits`` codes can share bytes (exact byte divisors only)."""
    return bits in _PACKABLE_BITS


def codes_per_byte(bits: int) -> int:
    if not is_packable(bits):
        raise ValueError(f"bits={bits} is not packable (need one of {_PACKABLE_BITS})")
    return 8 // bits


def packed_width(d: int, bits: int) -> int:
    """Bytes per row when packing ``d`` logical codes at ``bits`` bits."""
    cpb = codes_per_byte(bits)
    return -(-d // cpb)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed ``bits``-bit codes over the last axis into uint8."""
    cpb = codes_per_byte(bits)
    mask = (1 << bits) - 1
    d = codes.shape[-1]
    w = packed_width(d, bits)
    u = codes.to(torch.int32) & mask
    pad = w * cpb - d
    if pad:
        u = F.pad(u, (0, pad))
    u = u.reshape(*u.shape[:-1], w, cpb)
    shifts = torch.arange(cpb, dtype=torch.int32, device=codes.device) * bits
    return (u << shifts).sum(dim=-1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: uint8 container -> int8 codes ``[..., d]``."""
    cpb = codes_per_byte(bits)
    mask = (1 << bits) - 1
    shifts = torch.arange(cpb, dtype=torch.int32, device=packed.device) * bits
    vals = (packed.to(torch.int32).unsqueeze(-1) >> shifts) & mask
    flat = vals.reshape(*vals.shape[:-2], vals.shape[-2] * cpb)[..., :d]
    half = 1 << (bits - 1)
    return torch.where(flat >= half, flat - (1 << bits), flat).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class CodeStore:
    """A table of ``n x d`` signed codes in an explicit byte container.

    ``data`` is ``uint8 [n, packed_width(d, bits)]`` when ``packed`` else
    ``int8 [n, d]``.
    """

    data: torch.Tensor
    bits: int
    n: int
    d: int
    packed: bool

    @classmethod
    def from_codes(cls, codes: torch.Tensor, bits: int,
                   packed: bool | None = None) -> "CodeStore":
        """Wrap int8 codes ``[n, d]``; packs when the width allows it.

        ``packed=None`` means "pack if possible"; ``packed=True`` at a width
        that cannot pack keeps one byte per code, as in the reference.
        """
        n, d = codes.shape
        do_pack = is_packable(bits) if packed is None else (
            bool(packed) and is_packable(bits)
        )
        data = pack_codes(codes, bits) if do_pack else codes
        return cls(data=data, bits=int(bits), n=int(n), d=int(d), packed=do_pack)

    @property
    def shape(self) -> tuple[int, int]:
        """Logical (rows, codes-per-row) — not the byte container's shape."""
        return (self.n, self.d)

    @property
    def resident_bytes(self) -> int:
        """Actual container bytes: ``ceil(d * bits / 8)`` per row if packed."""
        return self.data.numel() * self.data.element_size()

    def unpack(self) -> torch.Tensor:
        """The full logical int8 ``[n, d]`` view (a copy when packed)."""
        if self.packed:
            return unpack_codes(self.data, self.bits, self.d)
        return self.data

    def take(self, ids: torch.Tensor) -> torch.Tensor:
        """Row gather -> int8 codes ``ids.shape + (d,)``."""
        rows = self.data[ids]
        if self.packed:
            return unpack_codes(rows, self.bits, self.d)
        return rows

    def set_rows(self, ids: torch.Tensor, codes_rows: torch.Tensor) -> "CodeStore":
        """Write int8 code rows ``[k, d]`` at ``ids`` [k] **in place** and
        return this store.  Ids outside ``[0, n)`` are dropped, as the
        reference's ``mode="drop"`` scatter drops them; a packed store packs
        the rows and writes bytes."""
        ids, codes_rows = in_range_rows(ids, codes_rows, self.n)
        rows = pack_codes(codes_rows, self.bits) if self.packed else codes_rows.to(torch.int8)
        self.data.index_copy_(0, ids, rows)
        return self


def in_range_rows(ids: torch.Tensor, rows: torch.Tensor, n: int):
    """``(ids, rows)`` as int64 ids in ``[0, n)`` and their rows: the rows a
    ``mode="drop"`` scatter keeps."""
    ids = ids.reshape(-1).to(torch.int64)
    keep = (ids >= 0) & (ids < n)
    if not bool(keep.all()):
        ids, rows = ids[keep], rows[keep]
    return ids, rows
