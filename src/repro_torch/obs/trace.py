"""Host-side span tracing with Chrome-trace JSON export (port of
repro/obs/trace.py).

Spans wrap **host** boundaries only, so a traced run launches the same
kernels on the same operands as an untraced one (bitwise equal results,
tests/test_torch_obs_sites.py).  The span catalog, the reference's names
and arguments:

    train.step        one CTR trainer step (fenced at its edge), one LM
                      step of the training CLI
    train.writeback   the hot-row cache's policy and moves after a CTR step
    train.refresh     the host refresh of methods that have one (prune)
    ckpt.save         checkpoint write (atomic rename included)
    ckpt.restore      checkpoint read + verify
    engine.wave       one Engine scheduler step
    engine.prefill    LM prefill of one admitted request
    engine.decode     LM decode step across the active slots
    engine.score      CTR wave scoring
    storage.cold.fetch     the cold tier's demand fetch of a wave's rows
    storage.cold.prefetch  the cold tier's staging of the next wave
    storage.writeback      dirty hot rows written back to the backing

plus one async span (``engine.request``) per request from submit to finish
and the instant ``train.straggler``.

Device-sync fences run **only at span edges and only while tracing is
enabled** (:meth:`Tracer.fence`): with tracing off the fence passes its
value through and launches stay asynchronous.  Spans record the host clock
only (``perf_counter_ns``); a fenced span therefore covers the card's work
of the kernels it launched.

With tracing off, ``tracer().span(...)`` returns one shared null context
manager, and ``instant`` / ``async_*`` return before reading the clock: no
allocation, no clock read, no sync.

Export is the Chrome trace-event JSON format: open the file in
``chrome://tracing`` or https://ui.perfetto.dev.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import torch

_NULL_CM = contextlib.nullcontext()


class _Span:
    """Context manager for one complete ('X') trace event."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict) -> None:
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        tr = self._tracer
        tr._events.append({
            "ph": "X", "name": self._name, "cat": self._name.split(".", 1)[0],
            "ts": (self._t0 - tr._epoch_ns) / 1e3, "dur": (t1 - self._t0) / 1e3,
            "pid": tr._pid, "tid": 0,
            **({"args": self._args} if self._args else {}),
        })


def _cuda_devices(value, found: set) -> set:
    """The CUDA devices of the tensors in ``value``, walking tuples (named
    ones included), lists and dict values."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    return found


class Tracer:
    """Span collector; the process-global one lives behind :func:`tracer`.

    Disabled by default.  ``enable(path)`` arms it and records the export
    path; ``export()`` writes the Chrome-trace JSON (the launch CLIs call it
    at exit).
    """

    def __init__(self) -> None:
        self.enabled = False
        self.out_path: str | None = None
        self._events: list[dict] = []
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()

    # ------------------------------------------------------------ control

    def enable(self, out_path: str | None = None) -> None:
        self.enabled = True
        self.out_path = out_path
        self._epoch_ns = time.perf_counter_ns()

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._events.clear()
        self._epoch_ns = time.perf_counter_ns()

    @property
    def events(self) -> list[dict]:
        return list(self._events)

    # ------------------------------------------------------------ spans

    def span(self, name: str, **args: Any):
        """Context manager timing one host-side phase (nesting in the trace
        follows call nesting); the shared null context while disabled."""
        if not self.enabled:
            return _NULL_CM
        return _Span(self, name, args)

    def _event(self, ph: str, name: str, args: dict, **extra) -> None:
        self._events.append({
            "ph": ph, **extra, "name": name, "cat": name.split(".", 1)[0],
            "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3, "pid": self._pid, "tid": 0,
            **({"args": args} if args else {}),
        })

    def instant(self, name: str, **args: Any) -> None:
        """Zero-duration marker ('i'), e.g. a straggler flag."""
        if self.enabled:
            self._event("i", name, args, s="t")

    def async_begin(self, name: str, aid: int, **args: Any) -> None:
        """Open one async span ('b'), e.g. a request entering the queue."""
        if self.enabled:
            self._event("b", name, args, id=aid)

    def async_end(self, name: str, aid: int, **args: Any) -> None:
        if self.enabled:
            self._event("e", name, args, id=aid)

    # ------------------------------------------------------------ fences

    def fence(self, value: Any) -> Any:
        """Device-sync fence at a span *edge*: while tracing, wait until the
        card has finished the work queued before this call on every CUDA
        device that holds a tensor of ``value`` (tensors in tuples, lists,
        dicts and NamedTuples), so the enclosing span measures the work and
        not its enqueue.  CPU tensors need no wait.  Returns ``value``
        unchanged (nothing is copied to the host); while disabled, a pure
        pass-through."""
        if self.enabled and value is not None:
            for device in _cuda_devices(value, set()):
                torch.cuda.synchronize(device)
        return value

    # ------------------------------------------------------------ export

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": list(self._events), "displayTimeUnit": "ms"}

    def export(self, path: str | None = None) -> str | None:
        """Write the Chrome-trace JSON; returns the path written (None when
        there is nowhere to write)."""
        path = path or self.out_path
        if path is None:
            return None
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global tracer every instrumented surface shares."""
    return _TRACER
