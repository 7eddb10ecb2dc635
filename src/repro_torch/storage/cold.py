"""Host-memory cold tier for serving tables larger than the device budget
(port of repro/storage/cold.py).

A :class:`ColdStore` keeps a quantized table's *container bytes* in host
memory (pinned when the table lives on a CUDA device, plain on the CPU);
the device holds the per-row Delta and a hot tier of ``cache_rows`` rows,
nothing else.  Per scoring wave:

1. :meth:`ColdStore.stage`, one wave ahead: the wave's distinct ids that
   the hot tier does not hold are gathered on the host into a pinned
   buffer and copied with ``non_blocking=True`` on a side stream, behind
   the current wave's scoring.  Cached rows do not travel;
2. :meth:`ColdStore.admit` runs the :class:`HotRowCache` policy over the
   wave's real ids and copies the admitted rows into the hot tier: from
   the staged rows on the device when they are there (an admitted id was
   a miss, so it was staged), else from host memory;
3. :meth:`ColdStore.rows` encodes each lookup as its hot slot, or as
   ``-1 - r`` for staged row ``r``, and one routed gather
   (``ops.dequant_gather_staged``) reads, unpacks and de-quantizes with the
   warm path's formula: bitwise a warm ``QuantTable.rows``.  A row that
   was cached when the wave was staged and evicted by its admissions is
   fetched then, into the same buffer (``topup_rows``); a wave that was
   not staged is fetched whole on demand (its misses only, after
   admission).

The reference stages every lookup's row and overrides the hits; here each
row crosses to the card at most once per wave, and ``copied_rows`` counts
the rows that did.  Two staging buffers alternate.  A host buffer is
refilled only after its last copy finished (its event), a device buffer
only after the reads of it (an event on the scoring stream), and the
scoring stream waits on the copy's event before it reads.  Routing happens
on the host (the policy's map): the device holds no map in cold mode.  The
store is read-only, so nothing is ever dirty.  The staging buffers are not
counted in ``device_bytes``, as the reference counts none.

Observability, as the reference's: :meth:`ColdStore.stage` is one
``storage.cold.prefetch`` span and a demand fetch in :meth:`ColdStore.rows`
one ``storage.cold.fetch`` span (``rows``: the wave's lookups), neither
fenced (the copies stay ordered by their events alone); the registry's
``storage.cold.prefetch_hits`` / ``demand_puts`` grow with the attributes
of those names.

Fault seams (:mod:`repro_torch.faults`), as the reference's, each on the
store's wave index (``wave``: the waves read so far).  Every host gather
(the staging, a top-up, a demand fetch, admitted rows not staged) runs
behind :func:`~repro_torch.faults.recovery.retry_with_backoff`
(``retry_stats``): ``cold.fetch`` stalls it ``stall_s`` and fails it
``fails`` times in its wave, and exhaustion raises ``RetryError``.  With
``codestore.corrupt`` in the plan, :meth:`ColdStore.stage` records the
crc32 of the rows it gathered, and on its waves flips one byte of the
staged copy (the reference's position rule over the port's staged rows);
:meth:`ColdStore.rows` checks the card's copy against that crc before use
and, on a mismatch, fetches again on demand (``corruption_detected``, a
``storage.cold.fetch`` span with ``reason="corrupt-staged"``).
``cold.prefetch_loss`` drops the staged copy and the wave is fetched on
demand (``prefetch_dropped``, ``reason="prefetch-lost"``).  The registry's
``storage.cold.prefetch_dropped`` / ``corruption_detected`` grow with the
attributes.  Without a plan the crc is never taken.
"""
from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from repro_torch.core.codestore import CodeStore
from repro_torch.faults import plan as faultplan
from repro_torch.faults.recovery import RetryStats, retry_with_backoff
from repro_torch.kernels import ops
from repro_torch.obs import counters as obs_counters
from repro_torch.obs.trace import tracer
from repro_torch.storage.tiered import HotRowCache

__all__ = ["ColdStore"]

# Cold-tier traffic in the registry (process-wide, across stores; the
# per-store counts stay on the ColdStore attributes the engines report).
_REG = obs_counters.registry()
_MET_PREFETCH_HITS = _REG.counter("storage.cold.prefetch_hits",
                                  "waves served from the staged prefetch")
_MET_DEMAND_PUTS = _REG.counter("storage.cold.demand_puts", "waves demand-fetched host->device")
_MET_PREFETCH_DROPPED = _REG.counter("storage.cold.prefetch_dropped",
                                     "staged prefetches lost (re-fetched)")
_MET_CORRUPTION = _REG.counter("storage.cold.corruption_detected", "staged bytes failing crc")


class _Stage:
    """One staging buffer: pinned host rows, their device copy, and the
    events that order refills against the copy and the gather."""

    def __init__(self, rows: int, width: int, dtype, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.empty((rows, width), dtype=dtype, pin_memory=cuda)
        self.host_np = self.host.numpy()
        self.dev = torch.empty((rows, width), dtype=dtype, device=device) if cuda else self.host
        self.copied = torch.cuda.Event() if cuda else None  # the host -> device copy is done
        self.read = torch.cuda.Event() if cuda else None  # the gather that read it is done


class ColdStore:
    """Host-resident quantized table + device hot tier + prefetch staging."""

    def __init__(self, codes: CodeStore, step: torch.Tensor, *, cache_rows: int,
                 name: str = "cold", use_kernel: bool = True):
        self.device = step.device
        cuda = self.device.type == "cuda"
        host = codes.data.detach().to("cpu")
        self.host = host.pin_memory() if cuda else host.clone()
        self.host_np = self.host.numpy()
        self.bits, self.packed, self.d_alloc = codes.bits, codes.packed, codes.d
        self.n_alloc = codes.n
        self.step = step
        self.use_kernel = use_kernel
        self.cache = HotRowCache(max(1, cache_rows), self.n_alloc, name=name)
        self.hot = torch.zeros((self.cache.capacity, self.host.shape[1]), dtype=self.host.dtype,
                               device=self.device)
        self._side = torch.cuda.Stream(device=self.device) if cuda else None
        self._stages: list[_Stage] = []
        self._turn = 0
        # (the staged wave's ids as bytes, its buffer, the ids of its rows)
        self._staged: tuple[bytes, _Stage, np.ndarray] | None = None
        # Host scratch: an id's row in the staging buffer that last held it
        # (stale entries are caught by checking the staged ids).  Written
        # whole here, so no wave pays the first touch of its pages.
        self._row_of_id = np.full(self.n_alloc, -1, np.int32)
        self.prefetch_hits = 0
        self.demand_puts = 0
        self.topup_rows = 0
        self.copied_rows = 0
        # Recovery: every host gather is retried (retry_stats); the fault
        # seams' counters and their schedule's basis, the wave index.
        self.retry_stats = RetryStats()
        self.prefetch_dropped = 0
        self.corruption_detected = 0
        self.wave = 0
        self._staged_crc: int | None = None  # crc32 of the staged rows (codestore.corrupt)
        self._fails_armed = 0  # cold.fetch: injected failures left in this wave
        self._armed_wave = -1

    # ------------------------------------------------------------ bytes

    @property
    def host_bytes(self) -> int:
        """The cold tier's host bytes (what exceeds the device budget)."""
        return int(self.host_np.nbytes)

    @property
    def hot_device_bytes(self) -> int:
        return self.hot.numel() * self.hot.element_size()

    @property
    def device_bytes(self) -> int:
        """What this store keeps on the device: hot rows + Delta."""
        return self.hot_device_bytes + self.step.numel() * self.step.element_size()

    # ------------------------------------------------------------ staging

    def _next_stage(self, rows: int) -> _Stage:
        """The staging buffer whose turn it is, its host half free to refill."""
        if not self._stages or self._stages[0].host.shape[0] != rows:
            width = self.host.shape[1]
            # Normal tensors, written in place whether or not the caller is
            # under inference_mode (the engine stages outside it).
            with torch.inference_mode(False):
                self._stages = [_Stage(rows, width, self.host.dtype, self.device)
                                for _ in range(2)]
        stage = self._stages[self._turn]
        self._turn ^= 1
        if stage.copied is not None:
            stage.copied.synchronize()
        return stage

    def _fetch(self, gather):
        """``gather()``, a host gather, behind bounded retry + backoff (the
        ``cold.fetch`` seam stalls it or fails it ``fails`` times in its
        wave; exhaustion raises ``RetryError``)."""
        spec = faultplan.lookup("cold.fetch")
        armed = spec is not None and spec.fires(self.wave)
        if armed and self._armed_wave != self.wave:
            self._armed_wave = self.wave
            self._fails_armed = int(spec.param("fails", 1))

        def attempt():
            if armed:
                stall = float(spec.param("stall_s", 0.0))
                if stall:
                    time.sleep(stall)
                if self._fails_armed > 0:
                    self._fails_armed -= 1
                    raise faultplan.TransientFault(f"cold.fetch injected failure (wave {self.wave})")
            return gather()

        attempts = int(spec.param("attempts", 4)) if spec is not None else 4
        return retry_with_backoff(attempt, op="cold.fetch", attempts=attempts, base_s=0.002,
                                  stats=self.retry_stats)

    def _fill(self, stage: _Stage, ids: np.ndarray, at: int = 0) -> None:
        """Gather the host rows ``ids`` into ``stage.host[at:]``."""
        self._fetch(lambda: np.take(self.host_np, ids, axis=0,
                                    out=stage.host_np[at: at + ids.size]))
        self.copied_rows += int(ids.size)

    def _corrupt(self, stage: _Stage, rows: int) -> int | None:
        """The ``codestore.corrupt`` seam on the rows just staged: their
        crc32 when the plan names the site (None otherwise), and on its
        waves one byte of the staged copy flipped at the reference's
        position, ``crc32(f"{seed}:{wave}") % bytes``."""
        spec = faultplan.lookup("codestore.corrupt")
        if spec is None:
            return None
        staged = stage.host_np[:rows].reshape(-1).view(np.uint8)
        crc = zlib.crc32(staged.tobytes())
        if spec.fires(self.wave) and staged.size:
            seed = int(spec.param("seed", 0))
            staged[zlib.crc32(f"{seed}:{self.wave}".encode()) % staged.size] ^= 0xFF
        return crc

    def _distinct(self, ids: np.ndarray, at: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """``(need, rows)``: the distinct ids of ``ids`` and each one's row
        ``at + i`` in ``need``'s order, in O(len(ids)) without a sort; the
        rows are recorded in the scratch map for :meth:`_staged_rows`."""
        mark = np.arange(ids.size, dtype=np.int32)
        self._row_of_id[ids] = mark  # one occurrence per id wins, whichever
        need = ids[self._row_of_id[ids] == mark]
        self._row_of_id[need] = np.arange(at, at + need.size, dtype=np.int32)
        return need, self._row_of_id[ids]

    def _staged_rows(self, staged: np.ndarray, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(rows, found)``: each id's row among the ``staged`` ids, and
        whether it is there (the scratch map may hold another wave's row)."""
        rows = self._row_of_id[ids]
        if not staged.size:
            return rows, np.zeros(ids.size, bool)
        return rows, staged[np.clip(rows, 0, staged.size - 1)] == ids

    def _safe(self, flat_ids) -> tuple[np.ndarray, np.ndarray]:
        flat_ids = np.asarray(flat_ids, np.int64).reshape(-1)
        return flat_ids, np.clip(flat_ids, 0, self.n_alloc - 1)

    def stage(self, flat_ids: np.ndarray) -> None:
        """Start the host -> device copy of a future wave's uncached rows."""
        flat_ids, safe = self._safe(flat_ids)
        key = flat_ids.tobytes()
        if self._staged is not None and self._staged[0] == key:
            return
        with tracer().span("storage.cold.prefetch", rows=int(flat_ids.size)):
            need, _ = self._distinct(safe[self.cache.slot_of_arr[safe] < 0])
            stage = self._next_stage(flat_ids.size)
            self._fill(stage, need)
            self._staged_crc = self._corrupt(stage, need.size)
            if self._side is not None:
                with torch.cuda.stream(self._side):
                    self._side.wait_event(stage.read)
                    stage.dev[: need.size].copy_(stage.host[: need.size], non_blocking=True)
                    stage.copied.record(self._side)
        self._staged = (key, stage, need)

    # ------------------------------------------------------------ serving

    def admit(self, flat_ids: np.ndarray) -> None:
        """Run the policy over a wave's real ids; copy the admitted rows to the
        hot tier on the current stream, from the staged rows when they hold
        them (and need no check), else from host memory."""
        moves = self.cache.observe(np.asarray(flat_ids, np.int64))
        if moves is None:
            return
        adm_slots, adm_ids = moves[3], moves[4]
        k = int((adm_ids >= 0).sum())
        adm_ids = adm_ids[:k].astype(np.int64)
        # Staged rows not yet verified (codestore.corrupt in the plan) are
        # not copied to the hot tier: admissions then come from host memory.
        if self._staged is not None and self._staged_crc is None:
            _, stage, need = self._staged
            pos, found = self._staged_rows(need, adm_ids)
            if found.all():
                idx = torch.from_numpy(np.stack([adm_slots[:k].astype(np.int64), pos]))
                slots, rows = idx.to(self.device)
                if stage.copied is not None:
                    torch.cuda.current_stream(self.device).wait_event(stage.copied)
                self.hot.index_copy_(0, slots, stage.dev.index_select(0, rows))
                if stage.read is not None:
                    stage.read.record()
                return
        rows = torch.from_numpy(self._fetch(lambda: self.host_np[adm_ids])).to(self.device)
        slots = torch.from_numpy(adm_slots[:k].astype(np.int64)).to(self.device)
        self.hot.index_copy_(0, slots, rows)
        self.copied_rows += k

    def rows(self, flat_ids: np.ndarray) -> torch.Tensor:
        """De-quantized f32 rows ``[k, d_alloc]`` of one wave's ids: cached
        rows from the hot tier, the others from the staged prefetch when it
        was made for these ids, else from a demand fetch; bitwise a warm
        ``QuantTable`` read."""
        flat_ids, safe = self._safe(flat_ids)
        slot = self.cache.slot_of_arr[safe]
        miss = slot < 0
        missed = safe[miss]
        staged, self._staged = self._staged, None
        crc, self._staged_crc = self._staged_crc, None
        reason = None
        spec = faultplan.lookup("cold.prefetch_loss")
        if spec is not None and spec.fires(self.wave) and staged is not None:
            # The staged copy is lost: the demand fetch below reads the host.
            staged, reason = None, "prefetch-lost"
            self.prefetch_dropped += 1
            _MET_PREFETCH_DROPPED.inc()
        if staged is not None and staged[0] != flat_ids.tobytes():
            staged = None  # staged for other ids
        if staged is not None:
            _, stage, need = staged
            if stage.copied is not None:
                torch.cuda.current_stream(self.device).wait_event(stage.copied)
            if crc is not None and zlib.crc32(stage.dev[: need.size].cpu().numpy().tobytes()) != crc:
                # Corrupted staged bytes: dropped, the wave fetched again.
                staged, reason = None, "corrupt-staged"
                self.corruption_detected += 1
                _MET_CORRUPTION.inc()
        if staged is not None:
            pos, found = self._staged_rows(need, missed)
            if not found.all():
                # Cached when staged, evicted by this wave's admissions.
                k0 = need.size
                extra, pos[~found] = self._distinct(missed[~found], at=k0)
                self._fill(stage, extra, at=k0)
                if stage.copied is not None:
                    stage.dev[k0: k0 + extra.size].copy_(stage.host[k0: k0 + extra.size],
                                                         non_blocking=True)
                    stage.copied.record()
                need = np.concatenate([need, extra])
                self.topup_rows += int(extra.size)
            self.prefetch_hits += 1
            _MET_PREFETCH_HITS.inc()
        else:
            kw = {} if reason is None else {"reason": reason}
            with tracer().span("storage.cold.fetch", rows=int(flat_ids.size), **kw):
                stage = self._next_stage(flat_ids.size)
                need, pos = self._distinct(missed)
                self._fill(stage, need)
                if stage.copied is not None:
                    stage.dev[: need.size].copy_(stage.host[: need.size], non_blocking=True)
                    stage.copied.record()
            self.demand_puts += 1
            _MET_DEMAND_PUTS.inc()
        slot[miss] = -1 - pos
        slot_ids = torch.from_numpy(np.stack([slot, flat_ids.astype(np.int32)])).to(self.device)
        out = ops.dequant_gather_staged(stage.dev[: need.size], self.hot, slot_ids[0], self.step,
                                        slot_ids[1], bits=self.bits, d=self.d_alloc,
                                        packed=self.packed, use_kernel=self.use_kernel)
        if stage.read is not None:
            stage.read.record()
        self.wave += 1
        return out

    def reset_counters(self) -> None:
        """Zero the traffic and recovery counters (the policy's too);
        membership persists."""
        self.cache.reset_counters()
        self.prefetch_hits = self.demand_puts = self.topup_rows = self.copied_rows = 0
        self.retry_stats = RetryStats()
        self.prefetch_dropped = self.corruption_detected = 0

    def warm_start(self, freqs) -> None:
        """Admit the top rows by frequency (a restarted server's warm cache)."""
        slots, ids = self.cache.warm_ids(freqs)
        if ids.size:
            self.hot.index_copy_(0, torch.from_numpy(slots).to(self.device),
                                 torch.from_numpy(self.host_np[ids]).to(self.device))
            self.copied_rows += int(ids.size)
