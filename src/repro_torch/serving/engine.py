"""The `Engine` core: resident table + request queue + metrics (port of
repro/serving/engine.py).

``submit`` enqueues, ``step`` advances the scenario's scheduler by one unit
of work, ``poll`` returns a finished request's result, ``run`` drains the
queue, ``metrics`` snapshots the counters.  Besides the reference's
resident-bytes accounting, the metrics count the kernel launches the
engine's own steps made, so a run shows that it went through the kernels.
With a storage tier (``CTREngine``'s hot-row cache or cold tier) they also
carry one :class:`CacheMetrics` per tier and slot, in the reference's
schema, mirrored into the obs registry's ``cache.*`` gauges.

Observability (:mod:`repro_torch.obs`), as the reference's: the registry's
``engine.requests_submitted`` / ``requests_completed`` / ``waves``
counters, labelled by scenario; one ``engine.wave`` span per step and one
async ``engine.request`` span per request, from submit to finish; wave and
request latency quantiles on the host clock (``EngineMetrics.latency_us``);
the kernel fallbacks the engine's steps noted (``fallback_report``).

Faults and recovery (:mod:`repro_torch.faults`), as the reference's:

* ``deadline_s``: a wave whose host time exceeds it ticks
  ``deadline_misses`` (``engine.deadline_misses``); the deadline is
  observed, not enforced;
* with a fault plan installed, a frontend whose ``_advance`` puts a failed
  wave back at the front of the queue (``_wave_retry_safe``: the CTR
  engine) runs each wave behind :func:`~repro_torch.faults.recovery
  .retry_with_backoff`, ``wave_attempts`` tries (``wave_retries``,
  ``retry_failures``); the final failure propagates;
* with ``cache.admission`` in the plan, a wave during which a tier refused
  admissions ticks ``served_degraded`` (``engine.served_degraded``);
* :meth:`Engine.health`: ready unless retries were exhausted (the waves' or
  a tier's fetches, ``_tier_retry_stats``), the residency is not integer, or
  a tier is over its budget; recovered degradation keeps it ready.

Without a plan a wave runs exactly as before, the deadline check aside.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

from repro_torch import methods
from repro_torch.faults import plan as faultplan
from repro_torch.faults.recovery import RetryStats, retry_with_backoff
from repro_torch.kernels import ops
from repro_torch.obs import counters as obs_counters
from repro_torch.obs import stats as obs_stats
from repro_torch.obs.trace import tracer
from repro_torch.serving import table as serving_tbl

# Engine counters, labelled by scenario so that CTR and LM engines in one
# process keep their tallies apart.  Observational: no computation reads them.
_REG = obs_counters.registry()
_MET_SUBMITTED = _REG.counter("engine.requests_submitted", "requests enqueued",
                              labels=("scenario",))
_MET_COMPLETED = _REG.counter("engine.requests_completed", "requests finished",
                              labels=("scenario",))
_MET_WAVES = _REG.counter("engine.waves", "scheduler steps taken", labels=("scenario",))
_MET_DEADLINE = _REG.counter("engine.deadline_misses", "waves over the per-wave deadline",
                             labels=("scenario",))
_MET_DEGRADED = _REG.counter("engine.served_degraded", "waves served degraded off the warm tier",
                             labels=("scenario",))
_CACHE_FIELDS = ("capacity", "rows_cached", "hits", "misses", "evictions", "writebacks",
                 "hit_rate", "hot_bytes", "metadata_bytes", "admission_oom", "prefetch_dropped",
                 "corruption_detected")


def _publish_cache_metrics(caches) -> None:
    """Mirror per-tier cache snapshots into the ``cache.*`` registry gauges."""
    for c in caches:
        for field in _CACHE_FIELDS:
            _REG.gauge(f"cache.{field}", labels=("tier", "name")).set(getattr(c, field), c.tier,
                                                                      c.name)


@dataclasses.dataclass(frozen=True)
class CacheMetrics:
    """One cache tier's snapshot (a hot-row cache slot or the cold tier)."""

    tier: str  # 'hot' (device hot-row cache) | 'cold' (host-backed)
    name: str  # slot name ('table', 'remainder', 'group0', ...)
    capacity: int  # rows the tier can hold
    rows_cached: int
    hits: int
    misses: int
    evictions: int
    writebacks: int
    hit_rate: float
    hot_bytes: int  # device bytes of the cached rows
    metadata_bytes: int  # id maps (device) + the policy's host state
    admission_oom: int = 0
    prefetch_dropped: int = 0
    corruption_detected: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class EngineMetrics:
    """Immutable snapshot of one engine's serving metrics."""

    scenario: str
    embedding_method: str
    requests_submitted: int
    requests_completed: int
    steps: int
    wall_s: float  # host clock over step(), which ends with results on the host
    resident_embedding_bytes: int
    embedding_code_bytes: int
    embedding_scale_bytes: int
    int8_resident: bool
    kernel_launches: dict[str, int]
    kernel_fallbacks: int  # noted by this engine's steps, since it was built
    tokens_generated: int = 0  # LM only
    caches: tuple[CacheMetrics, ...] = ()
    cache_hit_rate: float | None = None
    cache_budget_bytes: int | None = None
    prefetch_depth: int = 0
    served_degraded: int = 0  # waves during which a tier refused admissions
    deadline_misses: int = 0  # waves over ``deadline_s``
    wave_retries: int = 0  # wave-level retries (a tier's own are in its RetryStats)
    retry_failures: int = 0  # waves that exhausted their attempts
    #: Host-clock latency in µs, ``{"wave": {...}, "request": {...}}`` (each
    #: ``StreamingQuantiles.to_json()``); None until a wave ran, ``request``
    #: once a request finished.
    latency_us: dict | None = None

    def to_json(self) -> dict:
        """The schema: ``us_per_request`` once requests completed,
        ``tokens_generated`` / ``us_per_token`` for a token scenario, the
        cache keys only when a tier is on, ``latency_us`` once a wave ran (as
        the reference's)."""
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        if self.latency_us is None:
            del out["latency_us"]
        if self.requests_completed:
            out["us_per_request"] = self.wall_s / self.requests_completed * 1e6
        if self.tokens_generated:
            out["us_per_token"] = self.wall_s / self.tokens_generated * 1e6
        else:
            del out["tokens_generated"]
        if self.caches:
            out["caches"] = [c.to_json() for c in self.caches]
        else:
            for key in ("caches", "cache_hit_rate", "cache_budget_bytes", "prefetch_depth"):
                del out[key]
        return out


class Engine:
    """Shared serving core: resident table + queue + scheduler + metrics."""

    #: Scenario tag frontends set; shows up in metrics.
    scenario: str = "?"

    #: Frontends whose ``_advance`` puts a failed wave back at the front of
    #: the queue (so a retry sees the same requests) opt in to wave retry.
    _wave_retry_safe: bool = False

    def __init__(self, *, serving_table: serving_tbl.ServingTable,
                 spec: methods.EmbeddingSpec):
        self.table = serving_table
        self.spec = spec
        self._queue: collections.deque = collections.deque()
        self._done: dict[int, Any] = {}
        self._next_rid = 0
        self._submitted = 0
        self._completed = 0
        self._steps = 0
        self._wall_s = 0.0
        self._tokens = 0  # generated tokens (LM only)
        self._launches: collections.Counter = collections.Counter()
        # The launches and fallbacks of every step, over the engine's life.
        self._fallbacks = ops.FallbackScope()
        # Host-clock latency (µs) per wave and per request, submit to finish.
        self._wave_latency = obs_stats.StreamingQuantiles()
        self._request_latency = obs_stats.StreamingQuantiles()
        self._submit_ns: dict[int, int] = {}
        #: The storage tiers' device-bytes ceiling, when a frontend set one.
        self.cache_budget_bytes: int | None = None
        #: Waves staged ahead of the one being scored (the cold tier: 1).
        self.prefetch_depth = 0
        #: Per-wave deadline (seconds, host clock): a wave over it ticks
        #: ``deadline_misses`` (observed, not enforced).
        self.deadline_s: float | None = None
        #: Tries per wave under a fault plan (``_wave_retry_safe`` frontends).
        self.wave_attempts = 2
        #: Wave-level retry counters (a cold tier's fetch retries are its own).
        self.retry_stats = RetryStats()
        self._served_degraded = 0
        self._deadline_misses = 0

    @staticmethod
    def build_serving_state(table_state, spec: methods.EmbeddingSpec):
        """The method's serving-resident export for a table state."""
        return methods.get(spec.method).serving_state(table_state, spec)

    def submit(self, request) -> int:
        """Enqueue one request; returns its rid (assigned when ``rid`` is None)."""
        rid = request.rid
        if rid is None:
            rid = self._next_rid
            request = dataclasses.replace(request, rid=rid)
        self._next_rid = max(self._next_rid, rid + 1)
        self._queue.append(request)
        self._submitted += 1
        _MET_SUBMITTED.inc(1, self.scenario)
        self._submit_ns[rid] = time.perf_counter_ns()
        tracer().async_begin("engine.request", rid, scenario=self.scenario)
        return rid

    def poll(self, rid: int):
        """The finished result for ``rid``, or None while still in flight."""
        return self._done.get(rid)

    @property
    def pending(self) -> int:
        """Requests not yet finished."""
        return self._submitted - self._completed

    def step(self) -> bool:
        """Advance the scheduler by one unit of work; False once idle."""
        if not self._has_work():
            return False
        # Degraded waves are watched only while the plan schedules refusals.
        watch_oom = faultplan.lookup("cache.admission") is not None
        oom_before = self._admission_oom_total() if watch_oom else 0
        t0 = time.perf_counter()
        with tracer().span("engine.wave", scenario=self.scenario):
            with ops.fallback_scope(self._fallbacks), ops.fallback_scope() as wave:
                if faultplan.active_plan() is None or not self._wave_retry_safe:
                    self._advance()
                else:
                    retry_with_backoff(self._advance, op=f"{self.scenario}.wave",
                                       attempts=self.wave_attempts, base_s=0.002,
                                       stats=self.retry_stats)
        dt = time.perf_counter() - t0
        self._wall_s += dt
        self._steps += 1
        self._launches.update(wave.kernel_calls)
        self._wave_latency.add(dt * 1e6)
        _MET_WAVES.inc(1, self.scenario)
        if self.deadline_s is not None and dt > self.deadline_s:
            self._deadline_misses += 1
            _MET_DEADLINE.inc(1, self.scenario)
        if watch_oom and self._admission_oom_total() > oom_before:
            self._served_degraded += 1
            _MET_DEGRADED.inc(1, self.scenario)
        return True

    def run(self) -> dict[int, Any]:
        """Drain the queue; returns {rid: result} for everything finished."""
        while self.step():
            pass
        return dict(self._done)

    def _has_work(self) -> bool:
        """Queued requests, or (LM) requests still decoding in their slots."""
        return bool(self._queue)

    def _advance(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _finish(self, rid: int, result) -> None:
        self._done[rid] = result
        self._completed += 1
        _MET_COMPLETED.inc(1, self.scenario)
        t0 = self._submit_ns.pop(rid, None)
        if t0 is not None:
            self._request_latency.add((time.perf_counter_ns() - t0) / 1e3)
        tracer().async_end("engine.request", rid)

    @property
    def resident_embedding_bytes(self) -> int:
        """Embedding bytes kept resident: for integer tables, codes + scales."""
        return serving_tbl.resident_bytes(self.table)

    @property
    def embedding_code_bytes(self) -> int:
        return self.table.code_bytes()

    @property
    def embedding_scale_bytes(self) -> int:
        return self.table.scale_bytes()

    @property
    def int8_resident(self) -> bool:
        return serving_tbl.is_integer_resident(self.table)

    def cache_metrics(self) -> tuple[CacheMetrics, ...]:
        """Per-tier cache snapshots; () when no tier is composed in."""
        return ()

    def _admission_oom_total(self) -> int:
        return sum(c.admission_oom for c in self.cache_metrics())

    def _tier_retry_stats(self) -> list[tuple[str, RetryStats]]:
        """``(name, RetryStats)`` of each storage tier with a retried fetch."""
        return []

    def health(self) -> dict:
        """Readiness: is this engine fit to take traffic, and why.

        ``ready`` holds through *recovered* degradation (waves off the warm
        tier, retried fetches: the outputs are still bitwise right) and drops
        on what loses work or breaks the residency contract: exhausted
        retries, a non-integer residency, a tier over its budget.
        """
        retry_failures = self.retry_stats.failures + sum(
            s.failures for _, s in self._tier_retry_stats())
        checks = {
            "int8_resident": self.int8_resident,
            "within_budget": (self.cache_budget_bytes is None
                              or self.resident_embedding_bytes <= self.cache_budget_bytes),
            "no_retry_exhaustion": retry_failures == 0,
        }
        return {
            "ready": all(checks.values()),
            "checks": checks,
            "queue_depth": self.pending,
            "served_degraded": self._served_degraded,
            "deadline_misses": self._deadline_misses,
            "wave_retries": self.retry_stats.retries,
            "kernel_fallbacks": self.fallback_report()["total_fallbacks"],
        }

    def fallback_report(self) -> dict:
        """Launches and noted fallbacks of this engine's steps, over its life,
        in ``ops.fallback_stats``'s schema."""
        return self._fallbacks.stats()

    def _reset_cache_counters(self) -> None:
        """Frontends with cache tiers zero their traffic counters here."""

    def reset_metrics(self) -> None:
        """Zero the counters, launches and latencies (warm up, then measure).
        Finished results, cache membership and the fallback report are kept;
        the caches' traffic counters restart with the window."""
        self._submitted = self._completed = self._steps = self._tokens = 0
        self._served_degraded = self._deadline_misses = 0
        self._wall_s = 0.0
        self.retry_stats = RetryStats()
        self._launches = collections.Counter()
        self._wave_latency = obs_stats.StreamingQuantiles()
        self._request_latency = obs_stats.StreamingQuantiles()
        self._reset_cache_counters()

    def metrics(self) -> EngineMetrics:
        caches = self.cache_metrics()
        _publish_cache_metrics(caches)
        hit_rate = None
        if caches:
            hits = sum(c.hits for c in caches)
            total = hits + sum(c.misses for c in caches)
            hit_rate = hits / total if total else 0.0
        latency = None
        if self._wave_latency.count:
            latency = {"wave": self._wave_latency.to_json()}
            if self._request_latency.count:
                latency["request"] = self._request_latency.to_json()
        return EngineMetrics(
            scenario=self.scenario,
            embedding_method=self.spec.method,
            requests_submitted=self._submitted,
            requests_completed=self._completed,
            steps=self._steps,
            wall_s=self._wall_s,
            resident_embedding_bytes=self.resident_embedding_bytes,
            embedding_code_bytes=self.embedding_code_bytes,
            embedding_scale_bytes=self.embedding_scale_bytes,
            int8_resident=self.int8_resident,
            kernel_launches={k: v for k, v in self._launches.items() if v},
            kernel_fallbacks=self.fallback_report()["total_fallbacks"],
            tokens_generated=self._tokens,
            caches=caches,
            cache_hit_rate=hit_rate,
            cache_budget_bytes=self.cache_budget_bytes,
            prefetch_depth=self.prefetch_depth,
            served_degraded=self._served_degraded,
            deadline_misses=self._deadline_misses,
            wave_retries=self.retry_stats.retries,
            retry_failures=self.retry_stats.failures,
            latency_us=latency,
        )
