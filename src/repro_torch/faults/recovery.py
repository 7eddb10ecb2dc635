"""Bounded retry with deterministic exponential backoff (port of
repro/faults/recovery.py).

Every retried seam (the cold tier's host gathers, the dirty write-back, the
CTR engine's waves) goes through :func:`retry_with_backoff`, so the
discipline is one: bounded attempts, a deterministic backoff schedule (no
wall-clock jitter, so a chaos run replays), typed counters, and a loud
final failure (:class:`RetryError` chains the last cause; nothing is
swallowed).  Retries and exhaustions tick the registry's
``faults.retries`` / ``faults.retry_failures``, labelled by ``op``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, TypeVar

from repro_torch.faults.plan import InjectedFault
from repro_torch.obs import counters as obs_counters

T = TypeVar("T")

_MET_RETRIES = obs_counters.registry().counter(
    "faults.retries", "retry attempts across all retried seams", labels=("op",))
_MET_RETRY_FAILURES = obs_counters.registry().counter(
    "faults.retry_failures", "calls that exhausted all attempts", labels=("op",))


class RetryError(RuntimeError):
    """All attempts exhausted: raised loudly, chaining the last cause."""

    def __init__(self, op: str, attempts: int, last: BaseException):
        super().__init__(f"{op}: failed after {attempts} attempts: {last!r}")
        self.op = op
        self.attempts = attempts


@dataclasses.dataclass
class RetryStats:
    """One seam's retry counters, reported in end-of-run summaries."""

    calls: int = 0
    retries: int = 0
    failures: int = 0  # calls that exhausted every attempt
    backoff_s: float = 0.0  # the deterministic backoff slept, in total

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def backoff_schedule(attempts: int, base_s: float, factor: float = 2.0,
                     max_s: float = 1.0) -> tuple[float, ...]:
    """The sleep before each retry: ``base_s * factor**k``, capped at ``max_s``."""
    return tuple(min(base_s * factor**k, max_s) for k in range(max(0, attempts - 1)))


def retry_with_backoff(fn: Callable[[], T], *, op: str, attempts: int = 3,
                       base_s: float = 0.005, factor: float = 2.0, max_s: float = 1.0,
                       stats: RetryStats | None = None,
                       retry_on: tuple[type[BaseException], ...] = (InjectedFault, OSError,
                                                                    TimeoutError),
                       sleep: Callable[[float], None] = time.sleep) -> T:
    """``fn()`` with up to ``attempts`` tries and exponential backoff.

    Only exceptions in ``retry_on`` are retried; anything else (a real bug)
    propagates at once.  On exhaustion raises :class:`RetryError` from the
    last cause.  ``stats`` ticks calls / retries / failures and adds up the
    backoff applied.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if stats is not None:
        stats.calls += 1
    sched = backoff_schedule(attempts, base_s, factor, max_s)
    last: BaseException | None = None
    for k in range(attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 - a retry loop, not a hot path
            last = e
            if k == attempts - 1:
                break
            if stats is not None:
                stats.retries += 1
                stats.backoff_s += sched[k]
            _MET_RETRIES.inc(1, op)
            sleep(sched[k])
    if stats is not None:
        stats.failures += 1
    _MET_RETRY_FAILURES.inc(1, op)
    assert last is not None
    raise RetryError(op, attempts, last) from last
