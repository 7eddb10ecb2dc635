"""The port's observability layer (repro_torch.obs) against the reference's.

* Registry: typed counters / gauges with label tuples, snapshot / diff
  windows, the ``repro/obs/v1`` schema (the same document as the
  reference's after the same operations), loud kind / label mismatches.
* Tracer: spans as Chrome-trace complete events, the disabled path a shared
  null context, instants and async spans, export, and the fence: a
  pass-through while disabled, and while enabled a sync of each CUDA device
  its tensors lie on, none for CPU tensors, the value returned unchanged.
* Quantiles: P² within its accuracy, and ``==`` the reference's on seeded
  numpy streams, estimate for estimate.
* Gate: seeded baselines pass against their artifacts and fail on
  regressions and missing cells; classify / extract_cells / seed_baseline /
  compare give the reference's results on the same handmade documents (the
  BENCH files at the repository root are never read); the CLI.
* Kernels: launches counted once, in the registry (``kernels.kernel_calls``)
  and in the open scopes; ``fallback_stats()`` in the legacy schema.

The registries and tracers are process-global and shared by the test files
of a worker, so counts are read as snapshot diffs, never from 0.
"""
import json
import math

import numpy as np
import pytest
import torch

from repro.obs import counters as jcounters
from repro.obs import gate as jgate
from repro.obs import stats as jstats
from repro.obs import trace as jtrace
from repro_torch.kernels import _build, ops
from repro_torch.obs import counters as obs_counters
from repro_torch.obs import gate
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.counters import Registry
from repro_torch.obs.stats import P2Quantile, StreamingQuantiles
from repro_torch.obs.trace import Tracer, tracer


@pytest.fixture(autouse=True)
def _quiet_tracers():
    """Never leak an armed process-global tracer (either package's)."""
    for t in (tracer(), jtrace.tracer()):
        t.disable()
        t.clear()
    yield
    for t in (tracer(), jtrace.tracer()):
        t.disable()
        t.clear()


# ---------------------------------------------------------------- registry


class TestRegistry:
    def test_counter_inc_and_value(self):
        c = Registry().counter("t.hits")
        c.inc()
        c.inc(4)
        assert c.value() == 5

    def test_counter_rejects_negative(self):
        with pytest.raises(ValueError, match="cannot decrease"):
            Registry().counter("t.hits").inc(-1)

    def test_labeled_cells(self):
        c = Registry().counter("t.fallbacks", labels=("op", "reason"))
        c.inc(1, "gather", "shape")
        c.inc(2, "gather", "shape")
        c.inc(1, "update", "forced")
        assert (c.value("gather", "shape"), c.value("update", "forced"),
                c.value("gather", "nope")) == (3, 1, 0)

    def test_label_arity_checked(self):
        with pytest.raises(ValueError, match="takes labels"):
            Registry().counter("t.x", labels=("op",)).inc(1, "a", "b")

    def test_gauge_last_value_wins(self):
        g = Registry().gauge("t.bytes")
        g.set(100)
        g.set(42)
        assert g.value() == 42

    def test_get_or_create_is_same_object(self):
        reg = Registry()
        assert reg.counter("t.a", labels=("x",)) is reg.counter("t.a", labels=("x",))

    def test_kind_mismatch_raises(self):
        reg = Registry()
        reg.counter("t.a")
        with pytest.raises(TypeError, match="already registered as counter"):
            reg.gauge("t.a")

    def test_label_mismatch_raises(self):
        reg = Registry()
        reg.counter("t.a", labels=("x",))
        with pytest.raises(ValueError, match="labels"):
            reg.counter("t.a", labels=("y",))

    def test_snapshot_diff_isolates_window(self):
        reg = Registry()
        c = reg.counter("t.n", labels=("op",))
        g = reg.gauge("t.depth")
        c.inc(5, "a")
        g.set(3)
        before = reg.snapshot()
        c.inc(2, "a")
        c.inc(1, "b")
        g.set(9)
        delta = reg.snapshot().diff(before)
        assert (delta.value("t.n", "a"), delta.value("t.n", "b"), delta.value("t.depth")) == \
            (2, 1, 9)

    def test_snapshot_is_point_in_time(self):
        reg = Registry()
        c = reg.counter("t.n")
        c.inc()
        snap = reg.snapshot()
        c.inc(10)
        assert snap.value("t.n") == 1

    def test_to_json_schema(self):
        reg = Registry()
        reg.counter("t.plain").inc(7)
        reg.counter("t.labeled", labels=("op",)).inc(2, "gather")
        reg.gauge("t.depth").set(3)
        doc = reg.to_json()
        assert doc["schema"] == "repro/obs/v1"
        assert doc["counters"]["t.plain"] == 7
        assert doc["counters"]["t.labeled"] == [{"labels": {"op": "gather"}, "value": 2}]
        assert doc["gauges"]["t.depth"] == 3
        json.dumps(doc)

    def test_reset_zeroes_but_keeps_registrations(self):
        reg = Registry()
        c = reg.counter("t.n")
        c.inc(5)
        reg.reset()
        assert c.value() == 0 and "t.n" in reg.names()

    def test_global_registry_shared(self):
        assert obs_counters.registry() is obs_counters.registry()
        assert obs_counters.registry() is not jcounters.registry()

    def test_snapshot_documents_match_the_reference(self):
        """The same operations on both registries give the same document,
        window diffs included."""
        docs = []
        for mod in (obs_counters, jcounters):
            reg = mod.Registry()
            c = reg.counter("kernels.fallbacks", labels=("op", "shape", "reason"))
            n = reg.counter("engine.waves", labels=("scenario",))
            g = reg.gauge("cache.hit_rate", labels=("tier", "name"))
            p = reg.counter("ckpt.saves")
            c.inc(2, "dequant_gather", (8, 16), "test")
            n.inc(1, "ctr")
            before = reg.snapshot()
            n.inc(3, "ctr")
            n.inc(1, "lm")
            g.set(0.25, "hot", "table")
            p.inc()
            c.inc(1, "sr_round", (4,), "other")
            snap = reg.snapshot()
            docs.append((snap.to_json(), snap.diff(before).to_json(), reg.names()))
        assert docs[0] == docs[1]


# ----------------------------------------------------------------- tracing


class TestTracer:
    def test_disabled_span_is_shared_null_cm(self):
        t = Tracer()
        assert t.span("a") is t.span("b")
        with t.span("a"):
            pass
        t.instant("train.straggler", step=1)
        t.async_begin("engine.request", 1)
        t.async_end("engine.request", 1)
        assert t.events == []

    def test_span_nesting_chrome_events(self):
        t = Tracer()
        t.enable()
        with t.span("train.step", step=3):
            with t.span("train.writeback"):
                pass
        inner, outer = t.events
        assert [inner["name"], outer["name"]] == ["train.writeback", "train.step"]
        assert outer["ph"] == inner["ph"] == "X" and outer["cat"] == "train"
        assert outer["args"] == {"step": 3} and "args" not in inner
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3

    def test_instant_and_async_events(self):
        t = Tracer()
        t.enable()
        t.async_begin("engine.request", 7, scenario="ctr")
        t.instant("train.straggler", step=5)
        t.async_end("engine.request", 7)
        evs = t.events
        assert [e["ph"] for e in evs] == ["b", "i", "e"]
        assert evs[0]["id"] == evs[2]["id"] == 7 and evs[0]["args"] == {"scenario": "ctr"}
        assert evs[1]["s"] == "t" and evs[1]["cat"] == "train"

    def test_events_have_the_reference_keys(self):
        """Each event kind carries the reference tracer's keys."""
        got = []
        for t in (Tracer(), jtrace.Tracer()):
            t.enable()
            with t.span("ckpt.save", step=1):
                pass
            t.instant("train.straggler", step=2)
            t.async_begin("engine.request", 3, scenario="lm")
            t.async_end("engine.request", 3)
            got.append([(e["ph"], sorted(e)) for e in t.events])
        assert got[0] == got[1]

    def test_export_round_trips(self, tmp_path):
        t = Tracer()
        t.enable(str(tmp_path / "trace.json"))
        with t.span("ckpt.save", step=1):
            pass
        doc = json.loads(open(t.export()).read())
        assert doc["displayTimeUnit"] == "ms"
        assert doc["traceEvents"][0]["name"] == "ckpt.save"

    def test_export_nowhere_is_none(self):
        assert Tracer().export() is None

    def test_fence_passthrough_when_disabled(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "synchronize", _no_sync)
        t = Tracer()
        x = object()
        assert t.fence(x) is x and t.fence(None) is None

    def test_fence_on_cpu_tensors_syncs_nothing(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "synchronize", _no_sync)
        t = Tracer()
        t.enable()
        m = {"loss": torch.ones(()), "aux": (torch.zeros(2), [torch.zeros(1)]), "lr": 1e-3}
        assert t.fence(m) is m

    def test_fence_syncs_each_cuda_device_once(self, monkeypatch):
        """Tensors on CUDA devices anywhere in tuples, lists, dicts and
        NamedTuples: one synchronize per device, the value returned as is."""
        synced = []
        monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
        t = Tracer()
        value = {"a": (_FakeCuda(1), [torch.zeros(1)]), "b": [{"c": _FakeCuda(0)}],
                 "d": _Pair(_FakeCuda(1), 2.0)}
        assert t.fence(value) is value and synced == []
        t.enable()
        assert t.fence(value) is value
        assert sorted(synced, key=str) == [torch.device("cuda", 0), torch.device("cuda", 1)]

    def test_global_tracer_shared(self):
        assert tracer() is obs_trace.tracer() and tracer() is not jtrace.tracer()


def _no_sync(*args, **kwargs):
    raise AssertionError("the fence synchronized with nothing on a CUDA device")


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, for the fence's walk."""

    def __new__(cls, index):
        t = torch.Tensor._make_subclass(cls, torch.zeros(1))
        t._index = index
        return t

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", self._index)


class _Pair(tuple):
    """A NamedTuple-like tuple subclass."""

    def __new__(cls, a, b):
        return super().__new__(cls, (a, b))


# --------------------------------------------------------------- quantiles


def _streams():
    rng = np.random.RandomState(26)
    return {
        "lognormal": rng.lognormal(mean=3.0, sigma=0.7, size=2000),
        "uniform ties": np.round(rng.uniform(0, 50, size=997)),
        "step times": np.concatenate([rng.normal(7400.0, 90.0, 300),
                                      rng.normal(21000.0, 400.0, 7)])[rng.permutation(307)],
    }


class TestQuantiles:
    def test_exact_below_marker_count(self):
        p = P2Quantile(0.5)
        for v in (5.0, 1.0, 3.0):
            p.add(v)
        assert p.value() == 3.0

    def test_empty_is_nan(self):
        assert math.isnan(P2Quantile(0.5).value())

    def test_refuses_a_quantile_outside_0_1(self):
        with pytest.raises(ValueError, match="quantile"):
            P2Quantile(1.0)

    @pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
    def test_tracks_numpy_percentile(self, q):
        xs = np.random.RandomState(0).lognormal(mean=3.0, sigma=0.7, size=5000)
        est = P2Quantile(q)
        for x in xs:
            est.add(float(x))
        spread = float(np.percentile(xs, 99) - np.percentile(xs, 1))
        assert abs(est.value() - float(np.percentile(xs, q * 100))) <= 0.05 * spread

    def test_streaming_summary_json(self):
        s = StreamingQuantiles()
        assert s.to_json() == {"count": 0}
        for v in range(1, 101):
            s.add(float(v))
        doc = s.to_json()
        assert doc["count"] == 100 and doc["min"] == 1.0 and doc["max"] == 100.0
        assert doc["mean"] == pytest.approx(50.5)
        assert doc["p50"] == pytest.approx(50.5, rel=0.1)
        assert doc["p95"] == pytest.approx(95.0, rel=0.1)
        assert set(doc) == {"count", "mean", "min", "max", "p50", "p95", "p99"}

    @pytest.mark.parametrize("stream", ["lognormal", "uniform ties", "step times"])
    @pytest.mark.parametrize("q", [0.5, 0.95, 0.99, 0.1])
    def test_p2_equals_the_reference(self, stream, q):
        ours, theirs = P2Quantile(q), jstats.P2Quantile(q)
        for i, x in enumerate(_streams()[stream]):
            ours.add(float(x))
            theirs.add(float(x))
            if i < 12 or i % 97 == 0:
                assert ours.value() == theirs.value(), i
        assert ours.value() == theirs.value() and ours.count == theirs.count

    @pytest.mark.parametrize("stream", ["lognormal", "uniform ties", "step times"])
    def test_streaming_quantiles_equal_the_reference(self, stream):
        ours, theirs = StreamingQuantiles(), jstats.StreamingQuantiles()
        assert ours.to_json() == theirs.to_json()
        for i, x in enumerate(_streams()[stream]):
            ours.add(x)
            theirs.add(x)
            if i < 7:
                assert ours.to_json() == theirs.to_json()
        assert ours.to_json() == theirs.to_json()
        assert all(ours.quantile(q) == theirs.quantile(q) for q in StreamingQuantiles.DEFAULT_QS)


# ------------------------------------------------------------------- gate


def _e2e_doc(us=100.0, packed=512, fallbacks=0):
    return {
        "schema": "e2e/v1",
        "cells": {"ctr/bits8/kernels_on": {"us_per_step": us, "packed_bytes": packed,
                                           "shape_fallbacks": fallbacks, "table_rows": 128}},
        "obs_overhead": {"overhead_frac": 0.01},
    }


def _serving_doc(hit_rate=0.9, p95=1000.0):
    cell = {"scenario": "ctr", "embedding_method": "alpt", "cache_rows": 409, "cold_tier": True,
            "us_per_request": 50.0, "cache_hit_rate": hit_rate,
            "latency_us": {"wave": {"p95": p95}, "request": {"p50": 40.0, "count": 16}},
            "resident_embedding_bytes": 4096, "int8_resident": True}
    lm = {"scenario": "lm", "arch": "smollm-135m", "bits": 4, "cache_rows": 0,
          "us_per_token": 800.0, "kernel_fallbacks": 0}
    return {"cells": [cell, lm], "lm": [dict(lm, bits=8)],
            "ctr": [dict(cell, cold_tier=False, cache_rows=0)],
            "guard_overhead": {"overhead_frac": 0.015, "wall_s": 2.0},
            "chaos_serving": {"retry_failures": 0, "corruption_detected": 1}}


def _findings(found):
    return [f.to_json() for f in found]


class TestGate:
    def test_seed_then_self_compare_passes(self):
        doc = _e2e_doc()
        base = gate.seed_baseline({"BENCH_X.json": doc})
        assert base["schema"] == gate.SCHEMA == "repro/obs/bench-baseline/v1"
        assert gate.compare(base, {"BENCH_X.json": doc}) == []

    def test_time_regression_fails_past_tolerance(self):
        base = gate.seed_baseline({"BENCH_X.json": _e2e_doc(us=100.0)})
        assert gate.compare(base, {"BENCH_X.json": _e2e_doc(us=240.0)}) == []
        bad = gate.compare(base, {"BENCH_X.json": _e2e_doc(us=260.0)})
        assert len(bad) == 1 and bad[0].metric == "us_per_step"

    def test_bytes_and_count_are_exact(self):
        base = gate.seed_baseline({"BENCH_X.json": _e2e_doc()})
        grown = gate.compare(base, {"BENCH_X.json": _e2e_doc(packed=513)})
        assert [f.metric for f in grown] == ["packed_bytes"]
        fell = gate.compare(base, {"BENCH_X.json": _e2e_doc(fallbacks=1)})
        assert [f.metric for f in fell] == ["shape_fallbacks"]

    def test_missing_cell_and_artifact_are_findings(self):
        base = gate.seed_baseline({"BENCH_X.json": _e2e_doc()})
        assert any("missing" in f.message for f in gate.compare(base, {}))
        empty = gate.compare(base, {"BENCH_X.json": {"cells": {}}})
        assert any(f.cell == "ctr/bits8/kernels_on" for f in empty)

    def test_fresh_extra_cells_pass(self):
        base = gate.seed_baseline({"BENCH_X.json": _e2e_doc()})
        doc = _e2e_doc()
        doc["cells"]["ctr/bits4/kernels_on"] = {"us_per_step": 1e9}
        assert gate.compare(base, {"BENCH_X.json": doc}) == []

    def test_serving_list_cells_named_and_rate_gated(self):
        doc = _serving_doc()
        base = gate.seed_baseline({"BENCH_Y.json": doc})
        cells = base["benches"]["BENCH_Y.json"]["cells"]
        assert "ctr/alpt/cold" in cells and "latency_us.wave.p95" in cells["ctr/alpt/cold"]
        bad = gate.compare(base, {"BENCH_Y.json": _serving_doc(hit_rate=0.7)})
        assert sorted({f.metric for f in bad}) == ["cache_hit_rate"]

    @pytest.mark.parametrize("key", [
        "us_per_step", "latency_us.wave.p95", "wall_s", "embedding_code_bytes",
        "kernel_fallbacks", "corruption_detected", "cache_hit_rate", "overhead_frac",
        "table_rows", "latency_us.request.count", "x.p99", "steps"])
    def test_classify_equals_the_reference(self, key):
        assert gate.classify(key) == jgate.classify(key)

    @pytest.mark.parametrize("doc", [_e2e_doc(), _serving_doc(), {"cells": {}}, {}])
    def test_extract_cells_and_seed_equal_the_reference(self, doc):
        assert gate.extract_cells(doc) == jgate.extract_cells(doc)
        docs = {"BENCH_A.json": doc, "BENCH_B.json": _e2e_doc(us=7.0)}
        assert gate.seed_baseline(docs) == jgate.seed_baseline(docs)
        tol = {"time": 0.5, "rate": 0.1}
        assert gate.seed_baseline(docs, tol) == jgate.seed_baseline(docs, tol)

    @pytest.mark.parametrize("fresh", [
        {"BENCH_A.json": _serving_doc(), "BENCH_B.json": _e2e_doc()},
        {"BENCH_A.json": _serving_doc(hit_rate=0.5, p95=9000.0),
         "BENCH_B.json": _e2e_doc(us=1e6, packed=1, fallbacks=3)},
        {"BENCH_B.json": {"cells": {}}},
        {"BENCH_A.json": {"cells": [{"scenario": "ctr", "embedding_method": "alpt",
                                     "cache_rows": 409, "cold_tier": True}]}},
    ])
    def test_compare_equals_the_reference(self, fresh):
        docs = {"BENCH_A.json": _serving_doc(), "BENCH_B.json": _e2e_doc()}
        base = gate.seed_baseline(docs)
        base["benches"]["BENCH_B.json"]["cells"]["ctr/bits8/kernels_on"]["us_per_step"]["tol"] \
            = 0.1
        assert _findings(gate.compare(base, fresh)) == _findings(jgate.compare(base, fresh))

    def test_cli_seed_and_check(self, tmp_path, capsys):
        art = tmp_path / "BENCH_X.json"
        art.write_text(json.dumps(_e2e_doc()))
        base = tmp_path / "baseline.json"
        assert gate.main(["seed", "--out", str(base), str(art)]) == 0
        assert gate.load_baseline(base) == gate.seed_baseline({"BENCH_X.json": _e2e_doc()})
        assert gate.main(["check", "--baseline", str(base), "--root", str(tmp_path)]) == 0
        art.write_text(json.dumps(_e2e_doc(us=1e6)))
        report = tmp_path / "report.json"
        assert gate.main(["check", "--baseline", str(base), "--root", str(tmp_path),
                          "--report", str(report)]) == 1
        assert [f["metric"] for f in json.loads(report.read_text())] == ["us_per_step"]
        assert "1 finding(s)" in capsys.readouterr().out

    def test_load_baseline_refuses_another_schema(self, tmp_path):
        p = tmp_path / "b.json"
        p.write_text(json.dumps({"schema": "other"}))
        with pytest.raises(ValueError, match="schema"):
            gate.load_baseline(p)


# ---------------------------------------------------------------- kernels


def _fake_launch(monkeypatch, kernel, times=1):
    """``times`` launches of ``kernel`` through ``_build.launch``, its C entry
    point replaced by a function that returns success."""
    monkeypatch.setitem(_build._FNS, ("fake_source", "fake_fn"), lambda *args: 0)
    for _ in range(times):
        _build.launch(kernel, "fake_source", "fake_fn")


class TestKernelCounts:
    def test_launches_count_once_in_the_registry(self, monkeypatch):
        reg = obs_counters.registry()
        ops.reset_kernel_calls()
        before = reg.snapshot()
        _fake_launch(monkeypatch, "dequant_gather", 3)
        _fake_launch(monkeypatch, "sr_round")
        assert ops.kernel_calls() == {"dequant_gather": 3, "sr_round": 1}
        delta = reg.snapshot().diff(before)
        assert delta.values["kernels.kernel_calls"] == {("dequant_gather",): 3, ("sr_round",): 1}
        assert not hasattr(_build, "LAUNCHES")
        ops.reset_kernel_calls()
        assert ops.kernel_calls() == {} and reg.counter(
            "kernels.kernel_calls", labels=("op",)) is _build.KERNEL_CALLS

    def test_scopes_see_only_their_window(self, monkeypatch):
        _fake_launch(monkeypatch, "adam_update")
        ops.note_fallback("lpt_update", (3, 4), "outside")
        outer = ops.FallbackScope()
        with ops.fallback_scope(outer):
            _fake_launch(monkeypatch, "adam_update", 2)
            with ops.fallback_scope() as inner:
                ops.note_fallback("sparse_row_update", (5, 8), "no scratch row")
        with ops.fallback_scope(outer):  # re-entered: it accumulates
            _fake_launch(monkeypatch, "sr_round")
        assert outer.stats() == {
            "kernel_calls": {"adam_update": 2, "sr_round": 1},
            "fallbacks": [{"op": "sparse_row_update", "shape": "(5, 8)",
                           "reason": "no scratch row", "count": 1}],
            "total_fallbacks": 1}
        assert inner.stats()["kernel_calls"] == {} and inner.stats()["total_fallbacks"] == 1
        assert _build.SCOPES == []
        ops.reset_fallback_stats()

    def test_fallback_stats_keys(self):
        ops.reset_fallback_stats()
        stats = ops.fallback_stats()
        assert set(stats) == {"kernel_calls", "fallbacks", "total_fallbacks"}
        assert stats == {"kernel_calls": {}, "fallbacks": [], "total_fallbacks": 0}
        assert ops.kernel_calls() == {} and ops.fallbacks() == []

    def test_fallback_stats_reads_the_registry(self):
        ops.reset_fallback_stats()
        obs_counters.registry().counter(
            "kernels.fallbacks", labels=("op", "shape", "reason")).inc(
                2, "dequant_gather", "(8, 8)", "test-reason")
        want = [{"op": "dequant_gather", "shape": "(8, 8)", "reason": "test-reason",
                 "count": 2}]
        stats = ops.fallback_stats()
        assert stats["total_fallbacks"] == 2 and stats["fallbacks"] == want == ops.fallbacks()
        ops.reset_fallbacks()
        assert ops.fallbacks() == []

    def test_note_fallback_keys_as_the_reference(self, caplog):
        ops.reset_fallback_stats()
        for _ in range(2):
            ops.note_fallback("sparse_row_update", [4096, 16], "dr-rounding")
        assert ops.fallbacks() == [{"op": "sparse_row_update", "shape": "(4096, 16)",
                                    "reason": "dr-rounding", "count": 2}]
        assert sum("takes the plain path" in r.message for r in caplog.records) == 1
        ops.reset_fallback_stats()
