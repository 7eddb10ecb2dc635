"""Tiered row storage for quantized embedding tables (port of repro/storage).

Three tiers behind the code containers' one row surface (``take`` /
``set_rows`` / ``where_rows`` / ``unpack`` / ``resident_bytes``):

* **hot** — a device-resident cache of the hottest rows: the container,
  :class:`repro_torch.core.tiered.TieredCodes`, read and written on the
  card by routed kernels, and its policy, :mod:`repro_torch.storage.tiered`
  (LRU + frequency admission, dirty write-back), shared by training and
  serving;
* **warm** — :class:`repro_torch.core.codestore.CodeStore`: the device
  (possibly packed sub-byte) container;
* **cold** — :mod:`repro_torch.storage.cold`: pinned host memory, only a
  wave's missing rows staged to the card one wave ahead on a side stream,
  for tables larger than the device budget.

:mod:`repro_torch.storage.base` holds :class:`CacheSlot`, how a method
names its cacheable sub-tables.
"""
from repro_torch.storage import base, cold, tiered
from repro_torch.storage.base import CacheSlot
from repro_torch.storage.cold import ColdStore
from repro_torch.storage.tiered import HotRowCache

__all__ = ["base", "cold", "tiered", "CacheSlot", "ColdStore", "HotRowCache"]
