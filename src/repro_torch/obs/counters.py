"""One typed, namespaced counter/gauge registry for the port (port of
repro/obs/counters.py).

Every telemetry surface registers into the process-global :func:`registry`
under a dotted namespace::

    kernels.*   kernel launches and noted fallbacks (repro_torch.kernels)
    engine.*    serving Engine request / wave counters, by scenario
    cache.*     per-tier hot / cold cache gauges, by tier and name
    storage.*   dirty write-back rows, the cold tier's prefetch hits / puts
    train.*     straggler warnings of the training CLI
    ckpt.*      checkpoint saves, restores and refused restores

Metrics are **typed**: a :class:`Counter` only increments, a :class:`Gauge`
holds the last value set.  Both take label tuples declared up front, so a
structured tally (the kernels' per-``(op, shape, reason)`` fallbacks) lives
in the registry without flattening into names.

The registry is observational only: no tensor computation reads it, so a
run with every surface registering computes what a run without does.
``snapshot()`` returns an immutable :class:`Snapshot`; ``diff`` between two
snapshots isolates one window's activity.  ``to_json()`` is the wire schema,
tagged ``repro/obs/v1`` as the reference's, so either package's documents
read the same way.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Mapping

SCHEMA = "repro/obs/v1"


class Metric:
    """Base metric: a named family of (label-tuple -> value) cells."""

    kind = "?"

    def __init__(self, name: str, help: str = "", labels: tuple[str, ...] = ()) -> None:
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._values: dict[tuple, int | float] = {}
        self._lock = threading.Lock()

    def _key(self, label_values: tuple) -> tuple:
        if len(label_values) != len(self.labels):
            raise ValueError(f"{self.kind} '{self.name}' takes labels {self.labels}; "
                             f"got {label_values!r}")
        return tuple(map(str, label_values))

    def value(self, *label_values) -> int | float:
        return self._values.get(self._key(label_values), 0)

    def cells(self) -> dict[tuple, int | float]:
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


class Counter(Metric):
    """Monotonically increasing tally."""

    kind = "counter"

    def inc(self, amount: int | float = 1, *label_values) -> None:
        if amount < 0:
            raise ValueError(f"counter '{self.name}' cannot decrease (amount={amount})")
        key = self._key(label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount


class Gauge(Metric):
    """Last-value-wins measurement (bytes resident, hit rate, queue depth)."""

    kind = "gauge"

    def set(self, value: int | float, *label_values) -> None:
        key = self._key(label_values)
        with self._lock:
            self._values[key] = value

    def inc(self, amount: int | float = 1, *label_values) -> None:
        key = self._key(label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Immutable point-in-time view: {name: {label_tuple: value}}."""

    values: Mapping[str, Mapping[tuple, int | float]]
    kinds: Mapping[str, str]
    label_names: Mapping[str, tuple[str, ...]]

    def value(self, name: str, *label_values) -> int | float:
        cells = self.values.get(name, {})
        return cells.get(tuple(str(v) for v in label_values), 0)

    def diff(self, earlier: "Snapshot") -> "Snapshot":
        """This snapshot minus an earlier one: one window's activity.

        Counters subtract cell-wise (a cell missing earlier counts from 0);
        gauges keep their later value (a gauge *is* its last observation).
        """
        out: dict[str, dict[tuple, int | float]] = {}
        for name, cells in self.values.items():
            if self.kinds.get(name) == "gauge":
                out[name] = dict(cells)
                continue
            prev = earlier.values.get(name, {})
            d = {k: v - prev.get(k, 0) for k, v in cells.items() if v - prev.get(k, 0)}
            if d:
                out[name] = d
        return Snapshot(values=out, kinds=dict(self.kinds), label_names=dict(self.label_names))

    def to_json(self) -> dict:
        """The wire schema (``repro/obs/v1``): unlabelled metrics as scalars,
        labelled ones as a sorted list of ``{"labels": {...}, "value": n}``."""
        counters: dict = {}
        gauges: dict = {}
        for name in sorted(self.values):
            cells = self.values[name]
            names = self.label_names.get(name, ())
            dst = gauges if self.kinds.get(name) == "gauge" else counters
            if not names:
                dst[name] = cells.get((), 0)
                continue
            dst[name] = [{"labels": dict(zip(names, key)), "value": val}
                         for key, val in sorted(cells.items())]
        return {"schema": SCHEMA, "counters": counters, "gauges": gauges}


class Registry:
    """Get-or-create home for every metric, keyed by dotted name."""

    def __init__(self) -> None:
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, labels: Iterable[str]):
        labels = tuple(labels)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help=help, labels=labels)
                return m
        if not isinstance(m, cls):
            raise TypeError(f"metric '{name}' already registered as {m.kind}, not {cls.kind}")
        if m.labels != labels:
            raise ValueError(f"metric '{name}' already registered with labels {m.labels}, "
                             f"not {labels}")
        return m

    def counter(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Snapshot:
        with self._lock:
            metrics = dict(self._metrics)
        return Snapshot(values={n: m.cells() for n, m in metrics.items()},
                        kinds={n: m.kind for n, m in metrics.items()},
                        label_names={n: m.labels for n, m in metrics.items()})

    def reset(self) -> None:
        """Zero every metric's cells (registrations survive)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    def to_json(self) -> dict:
        return self.snapshot().to_json()


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-global registry every surface registers into."""
    return _REGISTRY
