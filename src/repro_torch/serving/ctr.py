"""CTR serving frontend: batched request scoring at fixed geometry (port of
repro/serving/ctr.py).

Requests (one [n_fields] vector of global feature ids each) are admitted in
waves of up to ``batch`` and padded to the fixed [batch, n_fields] geometry;
pad rows repeat the wave's first request and their outputs are discarded.
Each wave reads its rows straight off the resident table (integer codes
through ``ops.dequant_gather``, per sub-table for the composed methods; the
fp32 export of float-leaf methods) and runs the backbone's forward (DCN or
DeepFM), then the sigmoid.  Scores are per-row independent, so a request's
result does not depend on the wave it lands in.  ``from_checkpoint`` serves
a serving checkpoint.

Storage tiers (:mod:`repro_torch.storage`), as the reference's:

* ``cache_rows > 0`` composes a device hot-row cache over every cacheable
  sub-table (``serving.table.cache_slots``).  Per wave the policy observes
  the *real* requests' ids (never the padding) and its admissions are
  applied before scoring; the gathers take the routed kernels.  Serving is
  read-only, so the hot tier mirrors the backing and the scores are
  bitwise the uncached engine's.
* ``cold_tier=True`` moves a plain ``QuantTable``'s code container to host
  memory (:class:`repro_torch.storage.cold.ColdStore`): the device holds
  Delta and ``cache_rows`` hot rows; each wave's rows come from a host
  gather staged one wave ahead on a side stream, merged with the hot tier
  by the routed gather's staged route.  For tables larger than
  ``device_budget_bytes``.

A tier over ``device_budget_bytes`` raises, as in the reference.  Each
wave's scoring is one ``engine.score`` span (``tier="cold"`` on the cold
path), fenced on the probabilities while tracing.

Faults (:mod:`repro_torch.faults`), as the reference's: a wave that fails
goes back to the front of the queue, so the engine's wave retry (under a
fault plan) or the caller sees the same requests again
(``_wave_retry_safe``); the tiers' seams (``cache.admission``, the cold
tier's ``cold.fetch`` / ``cold.prefetch_loss`` / ``codestore.corrupt``)
report in ``CacheMetrics`` and the cold tier's ``retry_stats``
(``_tier_retry_stats``, read by ``health()``).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import methods
from repro_torch.checkpoint import manager as ckpt
from repro_torch.models import ctr as ctr_models
from repro_torch.obs.trace import tracer
from repro_torch.serving import table as serving_tbl
from repro_torch.serving.engine import CacheMetrics, Engine
from repro_torch.storage.cold import ColdStore
from repro_torch.storage.tiered import HotRowCache


@dataclasses.dataclass(frozen=True)
class CTRRequest:
    ids: np.ndarray  # [n_fields] int32 global feature ids
    rid: int | None = None


class CTREngine(Engine):
    scenario = "ctr"
    # _advance puts a failed wave back at the front of the queue, so the
    # engine's wave retry is safe here.
    _wave_retry_safe = True

    def __init__(self, dense: torch.nn.Module, serving_table: serving_tbl.ServingTable,
                 model_cfg, spec: methods.EmbeddingSpec, *, batch: int, cache_rows: int = 0,
                 cold_tier: bool = False, device_budget_bytes: int | None = None):
        super().__init__(serving_table=serving_table, spec=spec)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.dense = dense.eval()
        self.model_cfg = model_cfg
        self.batch = batch
        self.n_fields = model_cfg.n_fields
        self.n_rows = serving_table.live_rows()
        self.device = serving_table.tensors()[0].device
        dense_device = next(dense.parameters()).device
        if dense_device != self.device:
            raise ValueError(f"dense params on {dense_device}, table on {self.device}")
        self.cache_budget_bytes = device_budget_bytes
        self._caches: list = []  # [(CacheSlot, HotRowCache)]
        self._cold: ColdStore | None = None
        if cold_tier:
            if not isinstance(serving_table, serving_tbl.QuantTable):
                raise ValueError("cold_tier serves a plain QuantTable (single code container); "
                                 f"got {type(serving_table).__name__}")
            self._cold = ColdStore(serving_table.codes, serving_table.step,
                                   cache_rows=max(1, cache_rows),
                                   use_kernel=serving_table.use_kernels)
            self.prefetch_depth = 1
            self._d_live = serving_table.d
            # The device holds no code container in cold mode.
            self.table = None
            if device_budget_bytes is not None and self._cold.device_bytes > device_budget_bytes:
                raise ValueError(f"cold-tier device bytes {self._cold.device_bytes} exceed "
                                 f"budget {device_budget_bytes}")
            return
        if cache_rows > 0:
            table = self.table
            for slot in serving_tbl.cache_slots(table):
                sub = slot.get(table)
                cache = HotRowCache(max(1, min(int(cache_rows), slot.rows)), sub.codes.shape[0],
                                    name=slot.name)
                table = slot.put(table, dataclasses.replace(sub, codes=cache.wrap(sub.codes)))
                self._caches.append((slot, cache))
            self.table = table
            hot = sum(self._tiered(slot).hot_bytes + self._tiered(slot).metadata_bytes
                      for slot, _ in self._caches)
            if device_budget_bytes is not None and hot > device_budget_bytes:
                raise ValueError(f"hot-tier bytes {hot} exceed cache budget "
                                 f"{device_budget_bytes}")

    @classmethod
    def from_state(cls, state, cfg, *, batch: int, cache_rows: int = 0, cold_tier: bool = False,
                   device_budget_bytes: int | None = None) -> "CTREngine":
        """Build from a ``training.ctr_trainer.TrainState`` + its ``TrainerConfig``
        (a state without caches: ``CTRTrainer.export_state`` of a cached one)."""
        table = cls.build_serving_state(state.emb_state, cfg.spec)
        return cls(state.dense, table, cfg.model_cfg, cfg.spec, batch=batch,
                   cache_rows=cache_rows, cold_tier=cold_tier,
                   device_budget_bytes=device_budget_bytes)

    @classmethod
    def from_checkpoint(cls, directory, cfg, *, batch: int, step: int | None = None,
                        device: str | torch.device = "cuda", cache_rows: int = 0,
                        cold_tier: bool = False,
                        device_budget_bytes: int | None = None) -> "CTREngine":
        """Build from a serving checkpoint (``checkpoint.save_serving_checkpoint``
        of the backbone's ``param_tree()`` and the table): the backbone from
        ``cfg``, its params and the serving-resident table restored onto
        ``device``; codes restore as codes, straight into residency (or, with
        ``cold_tier``, through it into host memory)."""
        dev = device_mod.resolve(device)
        params, table, _ = ckpt.restore_serving_checkpoint(directory, cfg.spec, step=step,
                                                           device=dev)
        dense = ctr_models.MODELS[cfg.model][1](cfg.model_cfg, device=dev)
        return cls(dense.load_jax_params(params), table, cfg.model_cfg, cfg.spec, batch=batch,
                   cache_rows=cache_rows, cold_tier=cold_tier,
                   device_budget_bytes=device_budget_bytes)

    # ------------------------------------------------------------ tiers

    def _tiered(self, slot):
        return slot.get(self.table).codes

    def warm_start(self, freqs) -> None:
        """Pre-admit the hottest rows from global id counts ``freqs`` (e.g.
        training-time statistics shipped with a serving checkpoint)."""
        freqs = np.asarray(freqs, np.int64).reshape(-1)
        if self._cold is not None:
            self._cold.warm_start(freqs)
            return
        ids = np.arange(freqs.size)
        for slot, cache in self._caches:
            local = np.asarray(slot.local_ids(ids), np.int64)
            ok = (local >= 0) & (local < cache.n_alloc)
            lf = np.zeros(cache.n_alloc, np.int64)
            np.add.at(lf, local[ok], freqs[ok])
            cache.warm_start(self._tiered(slot), lf)

    def _maintain_caches(self, real_ids: np.ndarray) -> None:
        """Each slot's policy over the wave's *real* ids (the padding repeats
        request 0 and would inflate its hits); the admissions applied."""
        flat = real_ids.reshape(-1)
        for slot, cache in self._caches:
            cache.observe_apply(self._tiered(slot), slot.local_ids(flat))

    @property
    def policies(self) -> list[HotRowCache]:
        """The cache policies, one per slot (the cold tier's one)."""
        if self._cold is not None:
            return [self._cold.cache]
        return [cache for _, cache in self._caches]

    @property
    def cold(self) -> ColdStore | None:
        return self._cold

    def cache_metrics(self) -> tuple[CacheMetrics, ...]:
        if self._cold is not None:
            c = self._cold.cache
            return (CacheMetrics(
                tier="cold", name=c.name, capacity=c.capacity, rows_cached=c.rows_cached,
                hits=c.hits, misses=c.misses, evictions=c.evictions, writebacks=c.writebacks,
                hit_rate=c.hit_rate, hot_bytes=self._cold.hot_device_bytes,
                metadata_bytes=c.host_metadata_bytes, admission_oom=c.admission_oom,
                prefetch_dropped=self._cold.prefetch_dropped,
                corruption_detected=self._cold.corruption_detected),)
        out = []
        for slot, cache in self._caches:
            tiered = self._tiered(slot)
            out.append(CacheMetrics(
                tier="hot", name=cache.name, capacity=cache.capacity,
                rows_cached=cache.rows_cached, hits=cache.hits, misses=cache.misses,
                evictions=cache.evictions, writebacks=cache.writebacks,
                hit_rate=cache.hit_rate, hot_bytes=tiered.hot_bytes,
                metadata_bytes=tiered.metadata_bytes + cache.host_metadata_bytes,
                admission_oom=cache.admission_oom))
        return tuple(out)

    def _tier_retry_stats(self):
        return [] if self._cold is None else [("cold", self._cold.retry_stats)]

    def _reset_cache_counters(self) -> None:
        if self._cold is not None:
            self._cold.reset_counters()
        for _, cache in self._caches:
            cache.reset_counters()

    # ------------------------------------------------------------ bytes

    @property
    def resident_embedding_bytes(self) -> int:
        if self._cold is not None:
            return self._cold.device_bytes
        return super().resident_embedding_bytes

    @property
    def embedding_code_bytes(self) -> int:
        if self._cold is not None:
            return self._cold.hot_device_bytes
        return super().embedding_code_bytes

    @property
    def embedding_scale_bytes(self) -> int:
        if self._cold is not None:
            step = self._cold.step
            return step.numel() * step.element_size()
        return super().embedding_scale_bytes

    @property
    def int8_resident(self) -> bool:
        return self._cold is not None or super().int8_resident

    @property
    def cold_host_bytes(self) -> int:
        """Host bytes of the cold tier's code container (0 when warm)."""
        return self._cold.host_bytes if self._cold is not None else 0

    def submit(self, request: CTRRequest) -> int:
        ids = np.asarray(request.ids)
        if ids.shape != (self.n_fields,):
            raise ValueError(f"request ids shape {ids.shape} != ({self.n_fields},)")
        # The reference checks the shape only (its gather clamps or fills);
        # a hand-written gather must never be handed a row outside the table.
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_rows):
            raise ValueError(
                f"request ids must lie in [0, {self.n_rows}); got "
                f"[{ids.min()}, {ids.max()}]"
            )
        return super().submit(request)

    def _padded_wave_ids(self, reqs) -> np.ndarray:
        ids = np.zeros((self.batch, self.n_fields), np.int32)
        for i, req in enumerate(reqs):
            ids[i] = req.ids
        # Pad rows repeat request 0 (always in range); outputs discarded.
        ids[len(reqs):] = ids[0]
        return ids

    def _advance(self) -> None:
        wave = [self._queue.popleft() for _ in range(min(self.batch, len(self._queue)))]
        try:
            logits, probs = self._score_wave(wave)
        except BaseException:
            # Back to the front of the queue: a retry (the engine's, under a
            # fault plan, or the caller's) sees the same requests; a
            # transient tier failure loses no work.
            self._queue.extendleft(reversed(wave))
            raise
        for i, req in enumerate(wave):
            self._finish(req.rid, {"logit": logits[i], "prob": probs[i]})

    def _score_wave(self, wave) -> tuple[list, list]:
        """``(logits, probs)`` of one wave's requests, as host lists (the
        cold tier stages the next wave's rows before returning)."""
        ids_np = self._padded_wave_ids(wave)
        tr = tracer()
        with torch.inference_mode():
            if self._cold is not None:
                self._cold.admit(ids_np[: len(wave)].reshape(-1))
                d = self._d_live
                rows = self._cold.rows(ids_np.reshape(-1))[:, :d].reshape(*ids_np.shape, d)
                with tr.span("engine.score", wave=len(wave), tier="cold"):
                    logits = ctr_models.logits_from_rows(self.dense, rows)
                    probs = tr.fence(torch.sigmoid(logits))
            else:
                self._maintain_caches(ids_np[: len(wave)])
                with tr.span("engine.score", wave=len(wave)):
                    rows = self.table.rows(torch.from_numpy(ids_np).to(self.device))
                    logits = ctr_models.logits_from_rows(self.dense, rows)
                    probs = tr.fence(torch.sigmoid(logits))
        if self._cold is not None:
            # Stage the next wave's rows while this wave is scored.
            nxt = list(itertools.islice(self._queue, self.batch))
            if nxt:
                self._cold.stage(self._padded_wave_ids(nxt).reshape(-1))
        return logits.cpu().tolist(), probs.cpu().tolist()
