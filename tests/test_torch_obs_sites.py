"""The port's observability call sites (repro_torch.obs wired into the
trainers, engines, checkpoints, storage tiers and CLIs), against the
reference's where it has them.

* The contract: a traced run equals the same run untraced, bit for bit (CTR
  training with lpt, alpt, prune and under a hot-row cache; the CTR engine
  uncached, hot and cold; a SmolLM smoke ``LMEngine``'s greedy tokens; the
  LM CLI's losses), while the trace holds the spans the run passed through.
* The span catalog: a traced port run makes the reference's multiset of
  events on the same small CTR config (3 steps, then 16 requests served).
* The counters, read as snapshot diffs: ``engine.*`` equal
  ``EngineMetrics``, ``storage.*`` equal the tiers' own counts,
  ``ckpt.*`` count saves, restores and refused restores.
* The straggler watchdog flags the reference's steps on the same times.
* ``--trace-out`` on all four CLI subcommands; ``EngineMetrics.to_json()``
  keeps its keys and adds ``latency_us`` and ``kernel_fallbacks``.

The registries and tracers are process-global; every count is a diff.
"""
import collections
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import methods as jmethods
from repro.data.ctr_synth import CTRDatasetConfig as JDataConfig
from repro.data.ctr_synth import CTRSynthetic as JSynthetic
from repro.launch.train import StragglerWatchdog as JWatchdog
from repro.models.ctr import DCNConfig as JDCNConfig
from repro.obs import counters as jcounters
from repro.obs import trace as jtrace
from repro.serving.ctr import CTREngine as JEngine
from repro.serving.ctr import CTRRequest as JRequest
from repro.serving.engine import EngineMetrics as JEngineMetrics
from repro.training.ctr_trainer import CTRTrainer as JTrainer
from repro.training.ctr_trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs, methods
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.ctr import DCNConfig
from repro_torch.obs import counters as obs_counters
from repro_torch.obs.trace import tracer
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.serving.lm import LMEngine, LMRequest
from repro_torch.training import lm_trainer
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig, checkpoint_tree

jax.config.update("jax_platform_name", "cpu")

CARDS = (13, 29, 7, 53)
OBS_DATA = CTRDatasetConfig(name="obs", n_fields=4, cardinalities=CARDS, teacher_rank=2, seed=0)
DATA = CTRSynthetic(OBS_DATA)
DCN_KW = dict(n_fields=4, emb_dim=8, cross_depth=1, mlp_widths=(16,))
REG = obs_counters.registry()


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


def _traced(run):
    """``run()`` untraced, then again traced -> (untraced, traced, events)."""
    base = run()
    tracer().enable()
    try:
        got = run()
        events = tracer().events
    finally:
        tracer().disable()
        tracer().clear()
    return base, got, events


def _names(events) -> collections.Counter:
    return collections.Counter((e["ph"], e["name"]) for e in events)


def _trainer(method="alpt", bits=8, cache_rows=0):
    spec = methods.EmbeddingSpec(method=method, n=sum(CARDS), d=8, bits=bits, init_scale=0.05)
    return CTRTrainer(TrainerConfig(spec=spec, dcn=DCNConfig(**DCN_KW), cache_rows=cache_rows),
                      device="cpu")


def _leaf_bytes(trainer, state) -> list:
    tree = checkpoint_tree(trainer.cfg, trainer.export_state(state))
    def host(leaf):
        return leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf

    return [(path, np.asarray(host(leaf)).tobytes()) for path, leaf in ckpt.flatten(tree)]


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("method,cache_rows", [("lpt", 0), ("alpt", 0), ("prune", 0),
                                               ("alpt", 16)])
def test_ctr_training_traced_equals_untraced(method, cache_rows):
    steps = 4
    window = {}

    def run():
        trainer = _trainer(method, cache_rows=cache_rows)
        state = trainer.init_state()
        before = REG.snapshot()
        losses = []
        for i in range(steps):
            ids, labels = DATA.batch("train", i, 32)
            state, m = trainer.train_step(state, ids, labels)
            losses.append(np.asarray(m["loss"]).tobytes())
        window["delta"] = REG.snapshot().diff(before)
        window["writebacks"] = sum(s["writebacks"] for s in trainer.cache_stats())
        return losses, _leaf_bytes(trainer, state)

    base, got, events = _traced(run)
    assert got == base
    names = _names(events)
    assert names[("X", "train.step")] == names[("X", "train.writeback")] == steps
    assert [e["args"] for e in events if e["name"] == "train.step"] == \
        [{"step": i} for i in range(steps)]
    assert names[("X", "train.refresh")] == (steps if method == "prune" else 0)
    rows = window["delta"].value("storage.writeback_rows")
    assert rows == window["writebacks"]
    if cache_rows:
        spans = [e for e in events if e["name"] == "storage.writeback"]
        assert rows > 0 and spans and sum(e["args"]["rows"] for e in spans) == rows
        assert {e["args"]["store"] for e in spans} == {"table"}
    else:
        assert names[("X", "storage.writeback")] == 0


def test_cache_flush_is_a_writeback_span():
    trainer = _trainer("alpt", cache_rows=16)
    state = trainer.init_state()
    for i in range(3):
        state, _ = trainer.train_step(state, *DATA.batch("train", i, 32))
    (slot, cache), = trainer.caches
    dirty = int(cache.dirty.sum())
    before, wb = REG.snapshot(), cache.writebacks
    tracer().enable()
    cache.flush(slot.get(state.emb_state).codes)
    (span,) = [e for e in tracer().events if e["name"] == "storage.writeback"]
    assert dirty > 0 and span["args"] == {"rows": dirty, "store": cache.name}
    assert REG.snapshot().diff(before).value("storage.writeback_rows") == dirty
    assert cache.writebacks - wb == dirty


# ----------------------------------------------------------------- serving


def _trained_state(steps=2):
    trainer = _trainer("alpt")
    state = trainer.init_state()
    for i in range(steps):
        state, _ = trainer.train_step(state, *DATA.batch("train", i, 32))
    return trainer, state


@pytest.mark.parametrize("tier", ["uncached", "hot", "cold"])
def test_ctr_engine_traced_equals_untraced(tier):
    trainer, state = _trained_state()
    ids, _ = DATA.batch("test", 0, 20)
    kw = {"uncached": {}, "hot": {"cache_rows": 24},
          "cold": {"cache_rows": 24, "cold_tier": True}}[tier]
    seen = {}

    def run():
        engine = CTREngine.from_state(state, trainer.cfg, batch=8, **kw)
        before = REG.snapshot()
        rids = [engine.submit(CTRRequest(ids=row)) for row in ids]
        done = engine.run()
        seen.update(engine=engine, metrics=engine.metrics(),
                    delta=REG.snapshot().diff(before))
        return [done[r]["prob"] for r in rids]

    base, got, events = _traced(run)
    assert got == base  # exact float equality
    names = _names(events)
    assert names[("X", "engine.wave")] == names[("X", "engine.score")] == 3
    assert names[("b", "engine.request")] == names[("e", "engine.request")] == 20
    scores = [e["args"] for e in events if e["name"] == "engine.score"]
    cold = {"tier": "cold"} if tier == "cold" else {}
    assert scores == [{"wave": 8, **cold}, {"wave": 8, **cold}, {"wave": 4, **cold}]
    m, delta = seen["metrics"], seen["delta"]
    assert (delta.value("engine.requests_submitted", "ctr"),
            delta.value("engine.requests_completed", "ctr"),
            delta.value("engine.waves", "ctr")) == \
        (m.requests_submitted, m.requests_completed, m.steps) == (20, 20, 3)
    assert delta.value("engine.deadline_misses", "ctr") == 0
    for c in m.caches:
        assert delta.value("cache.hits", c.tier, c.name) == c.hits
        assert delta.value("cache.hit_rate", c.tier, c.name) == c.hit_rate
    if tier == "cold":
        store = seen["engine"].cold
        assert names[("X", "storage.cold.prefetch")] == 2
        assert names[("X", "storage.cold.fetch")] == 1
        assert (delta.value("storage.cold.prefetch_hits"),
                delta.value("storage.cold.demand_puts")) == \
            (store.prefetch_hits, store.demand_puts) == (2, 1)
    else:
        assert names[("X", "storage.cold.prefetch")] == names[("X", "storage.cold.fetch")] == 0


def test_engine_metrics_keep_their_keys_and_add_latency():
    trainer, state = _trained_state(1)
    engine = CTREngine.from_state(state, trainer.cfg, batch=8, cache_rows=24)
    assert "latency_us" not in engine.metrics().to_json()
    ids, _ = DATA.batch("test", 0, 12)
    for row in ids:
        engine.submit(CTRRequest(ids=row))
    engine.run()
    doc = engine.metrics().to_json()
    old = {"scenario", "embedding_method", "requests_submitted", "requests_completed", "steps",
           "wall_s", "resident_embedding_bytes", "embedding_code_bytes",
           "embedding_scale_bytes", "int8_resident", "kernel_launches", "us_per_request",
           "caches", "cache_hit_rate", "cache_budget_bytes", "prefetch_depth"}
    assert set(doc) == old | {"latency_us", "kernel_fallbacks", "served_degraded",
                              "deadline_misses", "wave_retries", "retry_failures"}
    assert set(doc) - {"kernel_launches"} <= {f.name for f in dataclasses.fields(
        JEngineMetrics)} | {"us_per_request"}
    assert doc["kernel_fallbacks"] == 0 and doc["requests_completed"] == 12
    for which, count in (("wave", 2), ("request", 12)):
        q = doc["latency_us"][which]
        assert q["count"] == count and q["p50"] <= q["p95"] <= q["p99"]
    json.dumps(doc)
    assert engine.fallback_report() == {"kernel_calls": {}, "fallbacks": [],
                                        "total_fallbacks": 0}
    engine.reset_metrics()
    m = engine.metrics()
    assert (m.requests_submitted, m.steps, m.wall_s, m.latency_us) == (0, 0, 0.0, None)
    assert all(c.hits == c.misses == 0 for c in m.caches) and m.caches[0].rows_cached > 0


def test_lm_engine_traced_equals_untraced():
    cfg = configs.smoke_config("smollm-135m")
    state = lm_trainer.init_state(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 3, 7)]
    decodes = []

    class Counting(LMEngine):
        def _decode(self):
            decodes.append(1)
            return super()._decode()

    def run():
        decodes.clear()
        engine = Counting.from_state(state, cfg, batch=2, max_len=16)
        rids = [engine.submit(LMRequest(prompt=p, max_new=4)) for p in prompts]
        done = engine.run()
        return [done[r] for r in rids]

    base, got, events = _traced(run)
    assert got == base
    prefills = [e["args"] for e in events if e["name"] == "engine.prefill"]
    assert prefills == [{"rid": i, "prompt_len": len(p)} for i, p in enumerate(prompts)]
    names = _names(events)
    assert names[("X", "engine.decode")] == len(decodes) > 0
    assert names[("b", "engine.request")] == names[("e", "engine.request")] == len(prompts)


# ------------------------------------------------------------ the catalog


def test_span_multiset_matches_the_reference():
    """3 training steps, then 16 requests served in waves of 8: the port's
    trace holds the reference's events, name for name and count for count."""
    jdata = JSynthetic(JDataConfig(name="obs", n_fields=4, cardinalities=CARDS, teacher_rank=2,
                                   seed=0))
    jspec = jmethods.EmbeddingSpec(method="alpt", n=sum(CARDS), d=8, bits=8, init_scale=0.05)
    jtr = JTrainer(JTrainerConfig(spec=jspec, model="dcn", dcn=JDCNConfig(**DCN_KW)))
    jtrace.tracer().enable()
    jstate = jtr.init_state()
    for i in range(3):
        jstate, _ = jtr.train_step(jstate, *jdata.batch("train", i, 32))
    jengine = JEngine.from_state(jstate, jtr.cfg, batch=8)
    ids, _ = jdata.batch("test", 0, 16)
    for row in ids:
        jengine.submit(JRequest(ids=row))
    jengine.run()
    want = _names(jtrace.tracer().events)

    tracer().enable()
    trainer, state = _trained_state(3)
    engine = CTREngine.from_state(state, trainer.cfg, batch=8)
    for row in DATA.batch("test", 0, 16)[0]:
        engine.submit(CTRRequest(ids=row))
    engine.run()
    assert _names(tracer().events) == want
    assert want[("X", "train.step")] == 3 and want[("b", "engine.request")] == 16


# ------------------------------------------------------------- counters


def test_checkpoint_counters_and_spans(tmp_path):
    manager = CheckpointManager(tmp_path, keep=3, save_every=1)
    before = REG.snapshot()
    tracer().enable()
    for step in (2, 4):
        manager.maybe_save({"w": torch.full((3,), float(step))}, step, force=True)
    leaf = tmp_path / "step_000000004" / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-3] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    tree, manifest = manager.restore(device="cpu")
    assert manifest["step"] == 2 and float(tree["w"][0]) == 2.0 and manager.corrupt_steps == [4]
    delta = REG.snapshot().diff(before)
    assert (delta.value("ckpt.saves"), delta.value("ckpt.restores"),
            delta.value("ckpt.corrupt_refused")) == (2, 1, 1)
    spans = [(e["name"], e["args"]) for e in tracer().events if e["cat"] == "ckpt"]
    assert spans == [("ckpt.save", {"step": 2}), ("ckpt.save", {"step": 4}),
                     ("ckpt.restore", {"step": 4}), ("ckpt.restore", {"step": 2})]
    ckpt.load_pytree(tmp_path, step=2, device="cpu")
    assert tracer().events[-1]["args"] == {"step": 2}
    with pytest.raises(ckpt.CorruptCheckpointError):
        ckpt.load_pytree(tmp_path, step=4, device="cpu")
    delta = REG.snapshot().diff(before)
    assert (delta.value("ckpt.restores"), delta.value("ckpt.corrupt_refused")) == (2, 2)


def test_registry_names_cover_the_reference_catalog():
    """Every counter the reference registers outside faults.* (A15b) is
    registered here too, with its kind and labels."""
    ours = REG.snapshot()
    theirs = jcounters.registry().snapshot()
    for name in theirs.kinds:
        if name.startswith("faults."):
            continue
        assert ours.kinds.get(name) == theirs.kinds[name], name
        assert ours.label_names.get(name) == theirs.label_names[name], name


@pytest.mark.parametrize("dts", [
    [1.0] * 6 + [3.0, 1.0, 1.0, 2.6, 2.4, 10.0, 1.0],
    [0.5, 5.0, 5.0, 5.0, 5.0, 5.0, 13.0, 0.1, 40.0],
    list(np.random.RandomState(7).lognormal(0.0, 0.6, 200)),
])
def test_straggler_watchdog_flags_the_reference_steps(dts):
    ours, theirs = train_cli.StragglerWatchdog(), JWatchdog()
    before = REG.snapshot()
    tracer().enable()
    flags = [(ours.observe(dt), theirs.observe(dt)) for dt in dts]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert (ours.ewma, ours.n, ours.flagged) == (theirs.ewma, theirs.n, theirs.flagged)
    flagged = [e["args"]["step"] for e in tracer().events if e["name"] == "train.straggler"]
    assert flagged == [i + 1 for i, (a, _) in enumerate(flags) if a]
    assert REG.snapshot().diff(before).value("train.straggler_warnings") == ours.flagged


# ------------------------------------------------------------------ CLIs


def _cli(main, argv, capsys) -> dict:
    assert main(argv) == 0
    out = capsys.readouterr()
    return {"report": json.loads(out.out.strip().splitlines()[-1]), "out": out.out,
            "err": out.err}


@pytest.mark.parametrize("which", ["train ctr", "train lm", "serve ctr", "serve lm"])
def test_cli_trace_out(which, tmp_path, capsys):
    path = tmp_path / "trace.json"
    main, argv = {
        "train ctr": (train_cli.main, ["ctr", "--scale", "0.001", "--batch", "32", "--steps",
                                       "3", "--device", "cpu"]),
        "train lm": (train_cli.main, ["lm", "--arch", "smollm-135m", "--smoke", "--device",
                                      "cpu", "--steps", "3", "--batch", "2", "--seq", "16"]),
        "serve ctr": (serve_cli.main, ["ctr", "--scale", "0.001", "--requests", "20",
                                       "--batch", "8", "--device", "cpu"]),
        "serve lm": (serve_cli.main, ["lm", "--arch", "smollm-135m", "--smoke", "--device",
                                      "cpu", "--requests", "3", "--batch", "2",
                                      "--prompt-len", "6", "--gen", "3"]),
    }[which]
    got = _cli(main, argv + ["--trace-out", str(path)], capsys)
    doc = json.loads(path.read_text())
    names = _names(doc["traceEvents"])
    assert f"trace written: {path}" in got["err"] and "tracing armed" in got["out"]
    assert not tracer().enabled and tracer().events == []
    report = got["report"]
    assert report["kernel_fallbacks"] == 0
    if which.startswith("train"):
        assert names[("X", "train.step")] == 3 and report["step_time_us"]["count"] == 3
        if which == "train lm":
            assert report["straggler_steps"] == 0
    else:
        waves = names[("X", "engine.wave")]
        assert waves == report["steps"] and report["latency_us"]["wave"]["count"] == waves
        assert report["latency_us"]["request"]["count"] == report["requests_completed"]


def test_lm_cli_losses_traced_equal_untraced(tmp_path, capsys):
    argv = ["lm", "--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16"]
    base = _cli(train_cli.main, argv, capsys)["report"]
    traced = _cli(train_cli.main, argv + ["--trace-out", str(tmp_path / "t.json")],
                  capsys)["report"]
    assert traced["losses"] == base["losses"] and len(base["losses"]) == 3
    assert "kernel_fallbacks" not in _cli(train_cli.main, argv + ["--no-kernels"],
                                          capsys)["report"]


@pytest.mark.parametrize("rank", ["0", "1"])
def test_trace_out_is_written_by_rank_0_only(rank, tmp_path, monkeypatch, capsys):
    """Under torch.distributed (RANK set) only rank 0 writes the trace, as
    only rank 0 saves; every rank disarms the tracer after the run, also
    after an error."""
    monkeypatch.setenv("RANK", rank)
    path = tmp_path / "trace.json"

    def run():
        with tracer().span("train.step", step=0):
            raise RuntimeError("step failed")

    with pytest.raises(RuntimeError, match="step failed"):
        train_cli.run_traced(str(path), "train", run)
    assert path.exists() == (rank == "0") and not tracer().enabled
    if rank == "0":
        assert [e["name"] for e in json.loads(path.read_text())["traceEvents"]] == ["train.step"]
