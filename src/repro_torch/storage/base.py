"""Cacheable sub-tables of a composed state (the ``CacheSlot`` half of
repro/storage/base.py).

Every code container of the port (:class:`repro_torch.core.codestore
.CodeStore`, :class:`repro_torch.core.tiered.TieredCodes`) has the same row
surface, ``shape`` / ``unpack`` / ``take`` / ``set_rows`` / ``where_rows``
/ ``resident_bytes``, and its callers call it directly.  The reference's
free functions over that surface (``logical_codes``, ``take_rows``,
``set_rows``, ``where_rows``, ``resident_bytes_of``), which also took raw
code arrays, have no caller in the port and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

__all__ = ["CacheSlot"]


@dataclasses.dataclass(frozen=True)
class CacheSlot:
    """One cacheable sub-table of a composed state (training or serving).

    A single-table method has one identity slot; qr_* have remainder and
    quotient slots; mixed one slot per bit-width group.  ``get`` / ``put``
    project the slot's table out of / back into the enclosing state;
    ``local_ids`` maps global feature ids (numpy) to the slot's local rows,
    -1 for ids outside the slot (the cache policy ignores them).
    """

    name: str
    rows: int  # live local id space of the slot's table
    get: Callable[[Any], Any]
    put: Callable[[Any, Any], Any]
    local_ids: Callable[[np.ndarray], np.ndarray]
