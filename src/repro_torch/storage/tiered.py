"""The hot-row cache's policy (port of repro/storage/tiered.py).

:class:`HotRowCache` is the host-side policy (numpy): LRU eviction with
frequency admission (a miss displaces the least recently used row only when
its lifetime count is strictly higher), per-slot dirty flags for write-back
before eviction, and hit / miss / eviction / write-back counters.
``observe`` takes a batch's ids and returns the moves, the reference's
arrays padded to capacity; ``apply`` executes them on the device container,
:class:`repro_torch.core.tiered.TieredCodes`, in the reference's order
(dirty write-back, map clears, then admissions gathered from the
written-back backing), in place.  Its decisions are the reference's move
for move, ties included, without the reference's O(capacity) scan per miss:
see :meth:`HotRowCache.observe`.

The cache holds *codes only*: Delta and the optimizer slots stay full-size
tensors indexed by id, which the routed paths read as before.  A move set
that writes dirty rows back, and a :meth:`HotRowCache.flush`, is one
``storage.writeback`` span (``rows``, ``store``); the registry's
``storage.writeback_rows`` grows wherever ``writebacks`` does, so over any
window it equals the sum of the caches' ``writebacks``.

Fault seams (:mod:`repro_torch.faults`), as the reference's:
``cache.admission`` makes :meth:`HotRowCache.observe` refuse a wave (its
index: the observe calls so far) before any policy state moves, counted in
``admission_oom``; the wave then runs off the backing, bitwise.  Unlike the
reference, a refused wave with ``write=True`` still marks the cached rows
it touched dirty: the routed row step wrote them to the hot tier, and the
reference, which does not, loses those writes at the next eviction or
export.  ``tiered.writeback`` fails :meth:`HotRowCache.flush`'s write-back
``fails`` times (its index: the flush calls so far); it runs behind
:func:`~repro_torch.faults.recovery.retry_with_backoff` (``retry_stats``,
``writeback_retries``), the write is idempotent, and on exhaustion
``RetryError`` is raised with the rows still flagged.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.codestore import CodeStore
from repro_torch.core.tiered import TieredCodes, apply_moves, wrap_codes, write_back
from repro_torch.faults import plan as faultplan
from repro_torch.faults.recovery import RetryStats, retry_with_backoff
from repro_torch.obs import counters as obs_counters
from repro_torch.obs.trace import tracer

__all__ = ["HotRowCache"]

_MET_WRITEBACK_ROWS = obs_counters.registry().counter(
    "storage.writeback_rows", "dirty hot rows written back to the backing tier")


class HotRowCache:
    """Host-side cache policy for one :class:`TieredCodes` slot.

    LRU victims with frequency admission: a miss takes a free slot
    unconditionally, but displaces the least recently used row only when
    its lifetime access count strictly exceeds the victim's.  ``policy_s``
    accumulates the host seconds :meth:`observe` takes.
    """

    def __init__(self, capacity: int, n_alloc: int, *, name: str = "codes"):
        capacity = int(min(capacity, n_alloc))
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = capacity
        self.n_alloc = int(n_alloc)
        self.slot_of_arr = np.full(self.n_alloc, -1, np.int32)
        self.slot_ids = np.full(capacity, -1, np.int64)
        self.freq = np.zeros(self.n_alloc, np.int64)
        self.last_used = np.zeros(capacity, np.int64)
        self.dirty = np.zeros(capacity, bool)
        # Slots are never freed: the free ones are [_next_free, capacity),
        # handed out lowest first (the reference's `_free.pop()` order).
        self._next_free = 0
        self.clock = 0
        self.hits = self.misses = self.evictions = self.writebacks = 0
        self.policy_s = 0.0
        # Waves refused on (injected) admission memory pressure: they run off
        # the backing tier, bitwise.
        self.admission_oom = 0
        self.observe_calls = 0  # the cache.admission seam's wave index
        self.flush_calls = 0  # the tiered.writeback seam's flush index
        self.retry_stats = RetryStats()  # the dirty write-back's retries

    # ------------------------------------------------------------ wrap

    def wrap(self, codes: CodeStore) -> TieredCodes:
        """Compose an empty hot tier over ``codes`` at this cache's capacity."""
        if codes.shape[0] != self.n_alloc:
            raise ValueError(f"codes rows {codes.shape[0]} != cache n_alloc {self.n_alloc}")
        return wrap_codes(codes, self.capacity)

    # ------------------------------------------------------------ policy

    def observe(self, ids, *, write: bool = False):
        """Account one batch of (local) ids; returns the moves or None.

        ``write=True`` marks the touched cached rows dirty (the routed row
        step wrote their new codes to the hot tier only).  Hits and misses
        are counted per occurrence against the membership before admission;
        ids outside ``[0, n_alloc)`` (other slots' traffic) are ignored.

        The reference admits the misses hottest first (a stable sort), and
        once no slot is free takes ``argmin(last_used)`` per miss, the
        lowest slot among equals.  Here the same victims come from one
        ordering: the slots not touched this batch, by (last_used, slot),
        taken in turn (a victim, once refilled, is at the clock and behind
        them all), then slot 0 once every slot is at the clock.  A miss that
        loses to its victim stops the batch: every later miss is no hotter
        and meets the same victim.
        """
        t0 = time.perf_counter()
        wave = self.observe_calls
        self.observe_calls += 1
        try:
            spec = faultplan.lookup("cache.admission")
            if spec is not None and spec.fires(wave):
                self._refuse(ids, write)
                return None
            return self._observe(ids, write)
        finally:
            self.policy_s += time.perf_counter() - t0

    def _refuse(self, ids, write: bool) -> None:
        """An injected admission OOM: nothing of the policy moves (no clock,
        counts or admissions); only the cached rows a write touched are
        flagged dirty, since the step wrote them to the hot tier."""
        self.admission_oom += 1
        if write:
            ids = np.asarray(ids).reshape(-1).astype(np.int64)
            slots = self.slot_of_arr[ids[(ids >= 0) & (ids < self.n_alloc)]]
            self.dirty[slots[slots >= 0]] = True

    def _observe(self, ids, write: bool):
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        ids = ids[(ids >= 0) & (ids < self.n_alloc)]
        self.clock += 1
        if ids.size == 0:
            return None
        uniq, counts = np.unique(ids, return_counts=True)
        self.freq[uniq] += counts
        slots = self.slot_of_arr[uniq]
        hit = slots >= 0
        self.hits += int(counts[hit].sum())
        self.misses += int(counts[~hit].sum())
        hot_slots = slots[hit]
        self.last_used[hot_slots] = self.clock
        if write:
            self.dirty[hot_slots] = True
        miss_ids = uniq[~hit]
        if miss_ids.size == 0:
            return None
        order = miss_ids[np.argsort(-self.freq[miss_ids], kind="stable")]
        n_free = min(self.capacity - self._next_free, order.size)
        adm_slots = [np.arange(self._next_free, self._next_free + n_free)]
        adm_ids = [order[:n_free]]
        self._next_free += n_free
        self._admit(adm_ids[0], adm_slots[0])
        rest = order[n_free:]
        ev: list[tuple] = []  # (victim slots, evicted ids, their dirty flags)
        if rest.size:
            cand = np.flatnonzero(self.last_used < self.clock)
            k = min(rest.size, cand.size)
            victims = self._oldest(cand, k)
            wins = self.freq[rest[:k]] > self.freq[self.slot_ids[victims]]
            taken = k if wins.all() else int(np.argmin(wins))
            self._replace(victims[:taken], rest[:taken], ev, adm_slots, adm_ids)
            if taken == cand.size and rest.size > taken:
                # Every slot is at the clock now: argmin(last_used) is slot 0.
                i = rest[taken: taken + 1]
                if self.freq[i[0]] > self.freq[self.slot_ids[0]]:
                    self._replace(np.zeros(1, np.int64), i, ev, adm_slots, adm_ids)
        adm_ids = np.concatenate(adm_ids)
        if adm_ids.size == 0:
            return None
        ev_slots, ev_ids, ev_dirty = [np.concatenate(x) for x in zip(*ev)] if ev else ([],) * 3
        return self._pad_moves(ev_slots, ev_ids, ev_dirty, np.concatenate(adm_slots), adm_ids)

    def _oldest(self, cand: np.ndarray, k: int) -> np.ndarray:
        """The ``k`` slots of ``cand`` with the smallest (last_used, slot)."""
        if k == 0:
            return cand[:0]
        key = self.last_used[cand] * self.capacity + cand  # unique per slot
        if k < cand.size:
            part = np.argpartition(key, k - 1)[:k]
            cand, key = cand[part], key[part]
        return cand[np.argsort(key)]

    def _replace(self, victims: np.ndarray, ids: np.ndarray, ev: list, adm_slots: list,
                 adm_ids: list) -> None:
        """Evict the rows of ``victims`` and admit ``ids`` there."""
        vid = self.slot_ids[victims]
        dirty = self.dirty[victims].copy()
        ev.append((victims, vid, dirty))
        self.evictions += int(victims.size)
        self._count_writebacks(int(dirty.sum()))
        self.slot_of_arr[vid] = -1
        self._admit(ids, victims)
        adm_slots.append(victims)
        adm_ids.append(ids)

    def _admit(self, ids: np.ndarray, slots: np.ndarray) -> None:
        self.slot_of_arr[ids] = slots
        self.slot_ids[slots] = ids
        self.last_used[slots] = self.clock
        self.dirty[slots] = False

    def _pad_moves(self, ev_slots, ev_ids, ev_dirty, adm_slots, adm_ids):
        """The moves as the reference returns them: int32 arrays (and a bool
        one) of length capacity, -1 / False past the live entries."""
        cap = self.capacity

        def pad_i32(vals):
            out = np.full(cap, -1, np.int32)
            out[: len(vals)] = vals
            return out

        dirty = np.zeros(cap, bool)
        dirty[: len(ev_dirty)] = ev_dirty
        return (pad_i32(ev_slots), pad_i32(ev_ids), dirty, pad_i32(adm_slots),
                pad_i32(adm_ids))

    # ------------------------------------------------------------ device

    def _count_writebacks(self, rows: int) -> None:
        if rows:
            self.writebacks += rows
            _MET_WRITEBACK_ROWS.inc(rows)

    def apply(self, tiered: TieredCodes, moves) -> TieredCodes:
        """Execute ``observe``'s moves on the device container, in place."""
        rows = int(np.count_nonzero(moves[2]))
        if not rows:
            return apply_moves(tiered, moves)
        with tracer().span("storage.writeback", rows=rows, store=self.name):
            return apply_moves(tiered, moves)

    def observe_apply(self, tiered: TieredCodes, ids, *, write: bool = False) -> TieredCodes:
        moves = self.observe(ids, write=write)
        return tiered if moves is None else self.apply(tiered, moves)

    def _dirty(self) -> tuple[np.ndarray, np.ndarray]:
        slots = np.flatnonzero(self.dirty)
        return slots, self.slot_ids[slots]

    def flush(self, tiered: TieredCodes) -> TieredCodes:
        """Write every dirty hot row back into the backing, in place;
        membership and the hot tier stay (training continues through the
        cache).  The write-back runs behind bounded retry + backoff (the
        ``tiered.writeback`` seam); it is idempotent, so a retried attempt
        writes what the first would have, and exhaustion raises
        ``RetryError`` with the rows still flagged."""
        slots, ids = self._dirty()
        flush_idx = self.flush_calls
        self.flush_calls += 1
        if not slots.size:
            return tiered
        spec = faultplan.lookup("tiered.writeback")
        fails = [int(spec.param("fails", 1)) if spec is not None and spec.fires(flush_idx)
                 else 0]

        def write():
            if fails[0] > 0:
                fails[0] -= 1
                raise faultplan.TransientFault(
                    f"tiered.writeback injected failure (flush {flush_idx})")
            write_back(tiered, slots, ids, tiered.backing.data)

        attempts = int(spec.param("attempts", 4)) if spec is not None else 4
        with tracer().span("storage.writeback", rows=int(slots.size), store=self.name):
            retry_with_backoff(write, op="tiered.writeback", attempts=attempts, base_s=0.002,
                               stats=self.retry_stats)
        self.dirty[:] = False
        self._count_writebacks(int(slots.size))
        return tiered

    def unwrap(self, tiered: TieredCodes) -> CodeStore:
        """A copy of the backing with the dirty hot rows folded in: bitwise
        the container a cache-off run holds.  The live container and the
        dirty flags are left as they are."""
        slots, ids = self._dirty()
        if not slots.size:
            return tiered.backing
        data = tiered.backing.data.clone()
        write_back(tiered, slots, ids, data)
        return dataclasses.replace(tiered.backing, data=data)

    def warm_ids(self, freqs) -> tuple[np.ndarray, np.ndarray]:
        """Admit, on the host, the top-capacity rows by the counts ``freqs``
        (e.g. training-time id statistics shipped with a serving checkpoint)
        into free slots; returns ``(slots, ids)`` admitted, in order."""
        f = np.asarray(freqs, np.int64).reshape(-1)
        full = np.zeros(self.n_alloc, np.int64)
        full[: min(f.size, self.n_alloc)] = f[: self.n_alloc]
        order = np.argsort(-full, kind="stable")
        order = order[full[order] > 0][: self.capacity]
        if order.size == 0:
            return np.zeros(0, np.int64), order
        self.freq += full
        if order.size > self.capacity - self._next_free:
            raise ValueError(f"warm start of {order.size} rows: {self.capacity - self._next_free} "
                             "slots free")
        self.clock += 1
        slots = np.arange(self._next_free, self._next_free + order.size)
        self._next_free += order.size
        self._admit(order, slots)
        return slots, order

    def warm_start(self, tiered: TieredCodes, freqs) -> TieredCodes:
        """Admit the top-capacity rows by ``freqs`` into an empty cache."""
        if self.rows_cached:
            raise ValueError("warm_start requires an empty cache")
        slots, ids = self.warm_ids(freqs)
        if not ids.size:
            return tiered
        return self.apply(tiered, self._pad_moves([], [], [], slots, ids))

    # ------------------------------------------------------------ metrics

    @property
    def rows_cached(self) -> int:
        return self._next_free  # a slot once filled stays filled

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def host_metadata_bytes(self) -> int:
        """Host bytes of the policy state (id map, recency and frequency)."""
        return int(self.slot_of_arr.nbytes + self.slot_ids.nbytes + self.freq.nbytes
                   + self.last_used.nbytes + self.dirty.nbytes)

    def reset_counters(self) -> None:
        """Zero the traffic counters (the policy's host seconds, the
        refusals and the retries too); membership and policy state persist."""
        self.hits = self.misses = self.evictions = self.writebacks = 0
        self.policy_s = 0.0
        self.admission_oom = 0
        self.retry_stats = RetryStats()

    def stats(self) -> dict:
        """The reference's keys."""
        return {
            "name": self.name, "capacity": self.capacity, "rows_cached": self.rows_cached,
            "hits": self.hits, "misses": self.misses, "evictions": self.evictions,
            "writebacks": self.writebacks, "admission_oom": self.admission_oom,
            "writeback_retries": self.retry_stats.retries, "hit_rate": self.hit_rate,
        }
