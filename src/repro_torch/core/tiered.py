"""A code container behind a device hot-row cache (the container half of
repro/storage/tiered.py).

:class:`TieredCodes` composes two :class:`~repro_torch.core.codestore.CodeStore`
of one layout: the ``backing`` store and a fixed-capacity ``hot`` store,
with two int32 maps, ``slot_of_id`` [n_alloc] and ``ids_of_slot``
[capacity] (-1: none), all on the table's device.  Reads overlay cached
rows on the backing; writes land in the hot tier for cached rows and in the
backing for the others.  The hot tier always holds a cached row's *current*
value, so every read is bitwise what an uncached table of the same logical
codes gives.  On the card the gathers and the CTR row step take routed
kernels (``ops.dequant_gather`` / ``ops.sparse_row_update_runs`` dispatch
on this type); there is no plain fallback there.

Membership changes come from the policy
(:class:`repro_torch.storage.tiered.HotRowCache`) as move arrays;
:func:`apply_moves` executes them on the device, in place, in the
reference's order.  Unlike the reference, the container is written **in
place** (as ``CodeStore`` is).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.codestore import CodeStore

__all__ = ["TieredCodes", "apply_moves", "wrap_codes", "write_back"]


@dataclasses.dataclass(frozen=True)
class TieredCodes:
    """Hot tier + backing tier behind the row-store surface.

    ``slot_of_id`` is int32 ``[n_alloc]`` (-1 = not cached); ``ids_of_slot``
    int32 ``[capacity]`` (-1 = free).  Both live on the table's device, so
    the routed kernels read them there; :class:`HotRowCache` keeps the host
    mirror.
    """

    backing: CodeStore
    hot: CodeStore  # [capacity, d], the backing's layout
    slot_of_id: torch.Tensor
    ids_of_slot: torch.Tensor

    # ------------------------------------------------------------ facade

    @property
    def shape(self) -> tuple[int, int]:
        return self.backing.shape

    @property
    def d(self) -> int:
        return self.backing.d

    @property
    def bits(self) -> int:
        return self.backing.bits

    @property
    def packed(self) -> bool:
        return self.backing.packed

    @property
    def device(self) -> torch.device:
        return self.backing.data.device

    @property
    def capacity(self) -> int:
        return int(self.ids_of_slot.shape[0])

    @property
    def hot_bytes(self) -> int:
        return self.hot.resident_bytes

    @property
    def metadata_bytes(self) -> int:
        """Device bytes of the id <-> slot maps (part of the cache's cost)."""
        return (self.slot_of_id.numel() + self.ids_of_slot.numel()) * 4

    @property
    def resident_bytes(self) -> int:
        """Backing + hot tier + maps: what the container keeps on the device."""
        return self.backing.resident_bytes + self.hot_bytes + self.metadata_bytes

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.backing.data, self.hot.data, self.slot_of_id, self.ids_of_slot)

    # ------------------------------------------------------------ routing

    def slots_for(self, ids: torch.Tensor) -> torch.Tensor:
        """Hot-tier slot per id (-1: not cached or outside ``[0, n)``)."""
        n = self.slot_of_id.shape[0]
        ids = ids.to(torch.int64)
        slot = self.slot_of_id[torch.clamp(ids, 0, n - 1)]
        return torch.where((ids >= 0) & (ids < n), slot, -1)

    # ------------------------------------------------------------ reads

    def unpack(self) -> torch.Tensor:
        """The full logical int8 [n, d] view: the backing overlaid with the
        cached rows (a copy)."""
        out = self.backing.unpack().clone()
        live = self.ids_of_slot >= 0
        out[self.ids_of_slot[live].to(torch.int64)] = self.hot.unpack()[live]
        return out

    def take(self, ids: torch.Tensor) -> torch.Tensor:
        """Routed gather -> int8 codes ``ids.shape + (d,)``: one backing
        gather and one hot gather, merged where the id is cached."""
        slot = self.slots_for(ids)
        hot = self.hot.take(torch.clamp(slot, min=0))
        return torch.where((slot >= 0)[..., None], hot, self.backing.take(ids))

    # ------------------------------------------------------------ writes

    def set_rows(self, ids: torch.Tensor, codes_rows: torch.Tensor) -> "TieredCodes":
        """Row scatter routed per id, **in place**: a cached id's row goes to
        the hot tier only (the policy marks it dirty), any other id's to the
        backing.  Ids outside ``[0, n)`` are dropped and a scratch row is
        written, exactly as the backing alone would do."""
        ids = ids.reshape(-1).to(torch.int64)
        slot = self.slots_for(ids)
        cached = slot >= 0
        self.hot.set_rows(torch.where(cached, slot, self.capacity), codes_rows)
        self.backing.set_rows(torch.where(cached, self.backing.n, ids), codes_rows)
        return self

    def where_rows(self, mask: torch.Tensor, new) -> "TieredCodes":
        """A new container with ``new``'s rows where ``mask`` [n] is set, in
        *both* tiers (no row turns dirty), this one's elsewhere."""
        new_codes = new.unpack() if hasattr(new, "where_rows") else new
        ids = self.ids_of_slot.to(torch.int64)
        safe = torch.clamp(ids, 0, self.backing.n - 1)
        sel = (ids >= 0) & mask[safe]
        hot = torch.where(sel[:, None], new_codes[safe], self.hot.unpack())
        return dataclasses.replace(
            self, backing=self.backing.where_rows(mask, new_codes),
            hot=CodeStore.from_codes(hot, self.hot.bits, packed=self.hot.packed))


def wrap_codes(codes: CodeStore, capacity: int) -> TieredCodes:
    """An empty hot tier of ``capacity`` rows composed over ``codes``."""
    if not isinstance(codes, CodeStore):
        raise TypeError(f"a hot-row cache wraps a CodeStore, got {type(codes).__name__}")
    dev = codes.data.device
    hot = CodeStore(data=torch.zeros((capacity, codes.data.shape[1]), dtype=codes.data.dtype,
                                     device=dev),
                    bits=codes.bits, n=int(capacity), d=codes.d, packed=codes.packed)
    return TieredCodes(backing=codes, hot=hot,
                       slot_of_id=torch.full((codes.n,), -1, dtype=torch.int32, device=dev),
                       ids_of_slot=torch.full((capacity,), -1, dtype=torch.int32, device=dev))


def _live(a: np.ndarray) -> np.ndarray:
    """The entries of a padded move array before its first -1."""
    return a[: int((a >= 0).sum())]


def apply_moves(tiered: TieredCodes, moves) -> TieredCodes:
    """One membership transaction on the device, in place, in the
    reference's order (``repro/storage/tiered.py:211``): the dirty evicted
    hot rows written back into the backing, the evicted ids cleared from
    both maps, then the admitted rows gathered from the written-back backing
    into the hot tier and mapped.  ``moves`` are the policy's padded arrays
    (:meth:`repro_torch.storage.tiered.HotRowCache.observe`'s); only their
    live prefixes travel to the device, in one copy."""
    ev_slots, ev_ids, ev_dirty, adm_slots, adm_ids = moves
    ev_slots, ev_ids = _live(ev_slots), _live(ev_ids)
    adm_slots, adm_ids = _live(adm_slots), _live(adm_ids)
    dirty = ev_dirty[: ev_ids.size]
    parts = [ev_slots, ev_ids, ev_slots[dirty], ev_ids[dirty], adm_slots, adm_ids]
    flat = torch.from_numpy(np.concatenate(parts).astype(np.int64)).to(tiered.device)
    es, ei, ds, di, as_, ai = torch.split(flat, [p.size for p in parts])
    back, hot = tiered.backing.data, tiered.hot.data
    if ds.numel():
        back.index_copy_(0, di, hot.index_select(0, ds))
    tiered.slot_of_id.index_fill_(0, ei, -1)
    tiered.ids_of_slot.index_fill_(0, es, -1)
    if as_.numel():
        hot.index_copy_(0, as_, back.index_select(0, ai))
        tiered.slot_of_id.index_copy_(0, ai, as_.to(torch.int32))
        tiered.ids_of_slot.index_copy_(0, as_, ai.to(torch.int32))
    return tiered


def write_back(tiered: TieredCodes, slots: np.ndarray, ids: np.ndarray,
                backing: torch.Tensor) -> None:
    """Copy the hot rows ``slots`` over ``backing``'s rows ``ids``."""
    flat = torch.from_numpy(np.concatenate([slots, ids]).astype(np.int64)).to(tiered.device)
    s, i = torch.split(flat, [slots.size, ids.size])
    backing.index_copy_(0, i, tiered.hot.data.index_select(0, s))
