"""The `Engine` core: resident table + request queue + metrics (port of
repro/serving/engine.py).

``submit`` enqueues, ``step`` advances the scenario's scheduler by one unit
of work, ``poll`` returns a finished request's result, ``run`` drains the
queue, ``metrics`` snapshots the counters.  Besides the reference's
resident-bytes accounting, the metrics count the kernel launches the
engine's own steps made, so a run shows that it went through the kernels.
Hot/cold storage tiers, fault injection and tracing are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

from repro_torch import methods
from repro_torch.kernels import ops
from repro_torch.serving import table as serving_tbl


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
    tokens_generated: int = 0  # LM only

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        if self.requests_completed:
            out["us_per_request"] = self.wall_s / self.requests_completed * 1e6
        if self.tokens_generated:
            out["us_per_token"] = self.wall_s / self.tokens_generated * 1e6
        else:
            del out["tokens_generated"]
        return out


class Engine:
    """Shared serving core: resident table + queue + scheduler + metrics."""

    #: Scenario tag frontends set; shows up in metrics.
    scenario: str = "?"

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
        before = ops.kernel_calls()
        t0 = time.perf_counter()
        self._advance()
        self._wall_s += time.perf_counter() - t0
        self._steps += 1
        for kernel, count in ops.kernel_calls().items():
            self._launches[kernel] += count - before.get(kernel, 0)
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

    def metrics(self) -> EngineMetrics:
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
            tokens_generated=self._tokens,
        )
