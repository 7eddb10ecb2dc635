"""`repro_torch.obs`: the port's observability layer (port of repro/obs).

* :mod:`~repro_torch.obs.counters`: the typed, namespaced counter / gauge
  registry every telemetry surface registers into (``kernels.*``,
  ``engine.*``, ``cache.*``, ``storage.*``, ``train.*``, ``ckpt.*``), with
  ``snapshot()`` / ``diff`` windows and one ``to_json()`` schema.
* :mod:`~repro_torch.obs.trace`: host-side spans with Chrome-trace JSON
  export (``--trace-out`` on both launch CLIs); device-sync fences only at
  span edges and only while tracing is enabled.
* :mod:`~repro_torch.obs.stats`: streaming P² quantiles behind the
  engines' ``latency_us`` and the training CLI's ``step_time_us``.
* :mod:`~repro_torch.obs.gate`: the perf-regression gate over BENCH json
  artifacts (``python -m repro_torch.obs.gate``).

The contract is the reference's: observability never changes a result.  A
traced run equals the untraced run bit for bit (tests/test_torch_obs_sites.py,
chip_smoke.py phase 14).
"""
from __future__ import annotations

from repro_torch.obs.counters import (  # noqa: F401
    Counter,
    Gauge,
    Registry,
    Snapshot,
    registry,
)
from repro_torch.obs.trace import tracer  # noqa: F401
