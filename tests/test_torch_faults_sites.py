"""Port parity for the fault seams of repro_torch (the storage tiers, the
engines, the kernels' dispatch, checkpoints and both CLIs), held against
repro.faults and the reference's stores: the second half of
tests/test_faults.py's contracts at its CHAOS_DATA size, plus ``health()``
and the CLIs' new flags with ``--device cpu``.

* Every recoverable seam is bitwise invisible: the cold tier's corrupted,
  failed and lost prefetches (its counters the reference store's on the
  same waves), refused cache admissions in training and serving, write-back
  retries, forced kernel fallbacks, an injected preemption and its resume.
* Exhaustion is loud: ``RetryError`` from the cold tier, the write-back
  (its rows still flagged) and an engine's wave; ``health()`` then reports
  ``no_retry_exhaustion`` False.
* A refused admission on a training wave keeps the hot tier's writes
  (marked dirty): the port's cached run stays bitwise the uncached one where
  the reference's loses them (a recorded deviation, ROADMAP Queue C).
* The registry's counters (``storage.cold.*``, ``engine.*``,
  ``faults.retries``, ``kernels.fallbacks``) move with the seams.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro.storage.cold import ColdStore as JColdStore
from repro.storage.tiered import HotRowCache as JHotRowCache
from repro_torch import faults, methods
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as ckpt
from repro_torch.checkpoint.manager import CorruptCheckpointError
from repro_torch.core.codestore import CodeStore
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.ctr import DCNConfig
from repro_torch.obs import counters as obs_counters
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.storage.cold import ColdStore
from repro_torch.storage.tiered import HotRowCache
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig, checkpoint_tree

pytestmark = pytest.mark.chaos

CHAOS_DATA = CTRDatasetConfig(name="chaos", n_fields=4, cardinalities=(13, 29, 7, 53),
                              teacher_rank=2, seed=0)
DATA = CTRSynthetic(CHAOS_DATA)
DCN_KW = dict(n_fields=CHAOS_DATA.n_fields, emb_dim=8, cross_depth=1, mlp_widths=(16,))
REG = obs_counters.registry()


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Plans are process-global in both packages: none leaks out of a test."""
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _plan(*specs, mod=faults):
    return mod.FaultPlan(specs=tuple(mod.FaultSpec(site=s, steps=st, always=a, params=p or {})
                                     for s, st, a, p in specs))


def _install_both(*specs):
    faults.install(_plan(*specs))
    jfaults.install(_plan(*specs, mod=jfaults))


def _trainer(method, *, cache_rows=0, guard=False):
    kw = dict(method=method, n=CHAOS_DATA.n_features, d=8, bits=8, init_scale=0.05)
    if method.startswith("qr"):
        kw["hash_compression"] = 4.0
    if method == "mixed":
        q, r = divmod(CHAOS_DATA.n_features, 4)
        kw.update(field_cards=(q, q, q, q + r), field_bits=(8, 4, 8, 2))
    return CTRTrainer(TrainerConfig(spec=methods.EmbeddingSpec(**kw), dcn=DCNConfig(**DCN_KW),
                                    cache_rows=cache_rows, guard=guard), device="cpu")


def _run(trainer, lo, hi, state=None):
    state = trainer.init_state() if state is None else state
    losses = []
    for i in range(lo, hi):
        state, m = trainer.train_step(state, *DATA.batch("train", i, 32))
        losses.append(float(m["loss"]))
    return state, losses


def _leaves(trainer, state):
    return ckpt.flatten(checkpoint_tree(trainer.cfg, trainer.export_state(state)))


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        pa == pb and torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        for (pa, x), (pb, y) in zip(a, b))


# ================================================================ cold tier


def _cold_codes(seed, n=64, d=16):
    rs = np.random.RandomState(seed)
    return (rs.randint(-127, 128, size=(n, d)).astype(np.int8),
            rs.uniform(0.01, 0.1, size=(n,)).astype(np.float32), rs)


def _port_cold(codes, step, bits=8, cache_rows=8):
    return ColdStore(CodeStore.from_codes(torch.from_numpy(codes), bits), torch.from_numpy(step),
                     cache_rows=cache_rows, name="chaos")


COLD_SEAMS = (("codestore.corrupt", (0,), False, None), ("cold.fetch", (1,), False, {"fails": 2}),
              ("cold.prefetch_loss", (2,), False, None))


def test_cold_tier_seams_are_bitwise_invisible_with_the_reference_counts():
    """Wave 0's staged bytes flipped, wave 1's gather failing twice, wave 2's
    prefetch lost: the rows equal the fault-free run's, and the counters
    equal the reference store's on the same waves (3 staged fetches + 2
    demand fetches; the registry's diff with them)."""
    codes, step, rs = _cold_codes(0)
    waves = [rs.randint(0, 64, size=8) for _ in range(3)]
    ref = _port_cold(codes, step)
    want = []
    for ids in waves:
        ref.stage(ids)
        want.append(ref.rows(ids))
    _install_both(*COLD_SEAMS)
    before = REG.snapshot()
    port = _port_cold(codes, step)
    jstore = JColdStore(jnp.asarray(codes), jnp.asarray(step), cache_rows=8, name="chaos")
    for ids, w in zip(waves, want):
        port.stage(ids)
        jstore.stage(ids)
        assert torch.equal(port.rows(ids), w)
        np.testing.assert_array_equal(np.array(jstore.rows(ids)), w.numpy())
    got = (port.corruption_detected, port.prefetch_dropped, port.demand_puts,
           port.retry_stats.to_json())
    assert got == (jstore.corruption_detected, jstore.prefetch_dropped, jstore.demand_puts,
                   jstore.retry_stats.to_json())
    assert got[:3] == (1, 1, 2) and port.retry_stats.calls == 5 and port.retry_stats.retries == 2
    delta = REG.snapshot().diff(before)
    assert delta.value("storage.cold.corruption_detected") == 1
    assert delta.value("storage.cold.prefetch_dropped") == 1
    assert delta.value("faults.retries", "cold.fetch") == 2


@pytest.mark.parametrize("bits", [4, 2])
def test_cold_tier_seams_bitwise_on_packed_codes(bits):
    lo = -(2 ** (bits - 1)) + 1
    codes, step, rs = _cold_codes(bits)
    codes = np.clip(codes, lo, -lo)
    waves = [rs.randint(0, 64, size=8) for _ in range(3)]
    ref = _port_cold(codes, step, bits)
    want = [(ref.stage(ids), ref.rows(ids))[1] for ids in waves]
    faults.install(_plan(*COLD_SEAMS))
    port = _port_cold(codes, step, bits)
    for ids, w in zip(waves, want):
        port.stage(ids)
        assert torch.equal(port.rows(ids), w)
    assert (port.corruption_detected, port.prefetch_dropped, port.retry_stats.retries) == (1, 1, 2)


def test_cold_fetch_exhaustion_raises_retry_error():
    codes, step, _ = _cold_codes(1, n=16, d=8)
    faults.install(_plan(("cold.fetch", (0,), False, {"fails": 5, "attempts": 2})))
    store = _port_cold(codes, step)
    with pytest.raises(faults.RetryError, match="cold.fetch"):
        store.stage(np.arange(4))
    assert store.retry_stats.failures == 1 and store.retry_stats.retries == 1


def test_cold_fetch_stall_is_applied():
    codes, step, _ = _cold_codes(2, n=16, d=8)
    faults.install(_plan(("cold.fetch", (0,), False, {"fails": 0, "stall_s": 0.02})))
    store = _port_cold(codes, step)
    import time
    t0 = time.perf_counter()
    store.stage(np.arange(4))
    assert time.perf_counter() - t0 >= 0.02 and store.retry_stats.retries == 0


def test_cold_counters_reset():
    codes, step, rs = _cold_codes(3)
    faults.install(_plan(*COLD_SEAMS))
    store = _port_cold(codes, step)
    for _ in range(3):
        ids = rs.randint(0, 64, size=8)
        store.stage(ids)
        store.rows(ids)
    store.reset_counters()
    assert (store.corruption_detected, store.prefetch_dropped, store.retry_stats.calls,
            store.cache.admission_oom) == (0, 0, 0, 0)


# ============================================================ tiered storage


@pytest.mark.parametrize("method", ["alpt", "qr_alpt", "mixed"])
def test_cache_admission_refusal_keeps_training_bitwise(method):
    """Every admission refused: the cache stays empty, every read and write
    goes to the backing; losses and the exported state bitwise cache-off;
    one refusal per slot and step."""
    ref_tr = _trainer(method)
    ref_state, ref_losses = _run(ref_tr, 0, 4)
    faults.install(_plan(("cache.admission", (), True, None)))
    tr = _trainer(method, cache_rows=4)
    state, losses = _run(tr, 0, 4)
    assert losses == ref_losses and _same(_leaves(tr, state), _leaves(ref_tr, ref_state))
    stats = tr.cache_stats()
    assert all(s["admission_oom"] == 4 and s["rows_cached"] == 0 for s in stats)
    assert all(s["hits"] == s["misses"] == 0 for s in stats)


def test_refused_training_wave_keeps_the_hot_tier_writes():
    """Admissions refused on wave 1 only, after wave 0 filled the cache: wave
    1's row step wrote cached rows to the hot tier, and the port flags them
    dirty, so the exported state is bitwise the uncached run's.  The
    reference's policy returns before flagging them and loses those writes
    (ROADMAP Queue C)."""
    from repro import methods as jmethods
    from repro.models import ctr as jctr
    from repro.training import ctr_trainer as jtr

    ref_tr = _trainer("alpt")
    ref_state, ref_losses = _run(ref_tr, 0, 2)
    _install_both(("cache.admission", (1,), False, None))
    tr = _trainer("alpt", cache_rows=8)
    state, losses = _run(tr, 0, 2)
    assert losses == ref_losses and _same(_leaves(tr, state), _leaves(ref_tr, ref_state))
    assert tr.cache_stats()[0]["admission_oom"] == 1 and tr.cache_stats()[0]["rows_cached"] == 8

    def jtrainer(cache_rows):
        spec = jmethods.EmbeddingSpec(method="alpt", n=CHAOS_DATA.n_features, d=8, bits=8,
                                      init_scale=0.05)
        return jtr.CTRTrainer(jtr.TrainerConfig(spec=spec, model="dcn",
                                                dcn=jctr.DCNConfig(**DCN_KW),
                                                cache_rows=cache_rows))

    out = []
    for cache_rows in (0, 8):
        t = jtrainer(cache_rows)
        s = t.init_state()
        for i in range(2):
            s, _ = t.train_step(s, *DATA.batch("train", i, 32))
        out.append(np.array(t.export_state(s).emb_state.codes.data))
    assert not np.array_equal(*out)  # the reference's refused wave lost hot-tier writes


def _dirty_cache(cls, codes, wrap_rows):
    """A 4-slot cache over an 8-row backing with rows 1, 2 cached and dirty."""
    cache = cls(4, 8, name="wb")
    tiered = cache.wrap(codes)
    tiered = cache.apply(tiered, cache.observe(np.array([1, 2])))
    tiered = tiered.set_rows(*wrap_rows)
    cache.observe(np.array([1, 2]), write=True)
    return cache, tiered


def _port_dirty(codes):
    rows = torch.tensor([[7, 7, 7, 7], [-7, -7, -7, -7]], dtype=torch.int8)
    return _dirty_cache(HotRowCache, CodeStore.from_codes(torch.from_numpy(codes), 8),
                        (torch.tensor([1, 2]), rows))


def _ref_dirty(codes):
    from repro.core.codestore import CodeStore as JCodeStore

    rows = jnp.asarray([[7, 7, 7, 7], [-7, -7, -7, -7]], jnp.int8)
    return _dirty_cache(JHotRowCache, JCodeStore.from_codes(jnp.asarray(codes), 8),
                        (jnp.array([1, 2]), rows))


def test_writeback_retry_is_bitwise_and_counted():
    codes = np.random.RandomState(2).randint(-5, 6, (8, 4)).astype(np.int8)
    cache, tiered = _port_dirty(codes)
    want = cache.flush(tiered).backing.data.clone()
    _install_both(("tiered.writeback", (0,), False, {"fails": 2}))
    before = REG.snapshot()
    cache, tiered = _port_dirty(codes)
    jcache, jtiered = _ref_dirty(codes)
    got = cache.flush(tiered).backing.data
    jgot = jcache.flush(jtiered).backing.data
    assert torch.equal(got, want) and np.array_equal(np.array(jgot), want.numpy())
    assert cache.retry_stats.to_json() == jcache.retry_stats.to_json()
    assert cache.retry_stats.retries == 2 and not cache.dirty.any()
    assert cache.stats()["writeback_retries"] == jcache.stats()["writeback_retries"] == 2
    assert REG.snapshot().diff(before).value("faults.retries", "tiered.writeback") == 2


def test_writeback_exhaustion_keeps_rows_flagged():
    faults.install(_plan(("tiered.writeback", (0,), False, {"fails": 5, "attempts": 2})))
    cache, tiered = _port_dirty(np.zeros((8, 4), np.int8))
    with pytest.raises(faults.RetryError, match="tiered.writeback"):
        cache.flush(tiered)
    assert cache.retry_stats.failures == 1 and cache.dirty.any()
    assert torch.equal(tiered.backing.data[1:3], torch.zeros(2, 4, dtype=torch.int8))
    faults.uninstall()
    cache.flush(tiered)  # flush 1: the rows are written now
    assert not cache.dirty.any() and int(tiered.backing.data[1, 0]) == 7


# =============================================================== checkpoints


def test_checkpoint_corruption_falls_back_to_last_good(tmp_path):
    trees = [{"s": torch.tensor(k, dtype=torch.int32), "w": torch.arange(6.0).reshape(2, 3) * k}
             for k in (1, 2)]
    mgr = CheckpointManager(tmp_path, keep=5, save_every=1)
    for k, tree in enumerate(trees, 1):
        assert mgr.maybe_save(tree, k)
    faults.corrupt_checkpoint_leaf(tmp_path, 2)
    restored, manifest = mgr.restore(device="cpu")
    assert manifest["step"] == 1 and mgr.corrupt_steps == [2]
    assert torch.equal(restored["w"], trees[0]["w"])
    with pytest.raises(CorruptCheckpointError):
        mgr.restore(step=2, device="cpu")
    faults.corrupt_checkpoint_leaf(tmp_path, 1)
    fresh = CheckpointManager(tmp_path, keep=5, save_every=1)
    with pytest.raises(CorruptCheckpointError, match="failed verification"):
        fresh.restore(device="cpu")
    assert fresh.corrupt_steps == [2, 1]


@pytest.mark.parametrize("method", ["lpt", "alpt", "qr_alpt", "mixed"])
def test_exact_resume_parity(method, tmp_path):
    """3 steps through a hot-row cache, a checkpoint, a fresh trainer's
    restore, 3 more: losses and the exported state bitwise the
    uninterrupted uncached run's."""
    ref_tr = _trainer(method)
    ref_state, ref_losses = _run(ref_tr, 0, 6)
    tr1 = _trainer(method, cache_rows=4)
    s1, l1 = _run(tr1, 0, 3)
    assert tr1.save(CheckpointManager(tmp_path, keep=2, save_every=100), s1, force=True)
    tr2 = _trainer(method, cache_rows=4)
    s2 = tr2.restore(CheckpointManager(tmp_path, keep=2, save_every=100))
    s2, l2 = _run(tr2, 3, 6, s2)
    assert l1 + l2 == ref_losses and _same(_leaves(tr2, s2), _leaves(ref_tr, ref_state))


# ================================================================== serving


def _score(engine, ids):
    rids = [engine.submit(CTRRequest(ids=row)) for row in ids]
    done = engine.run()
    return [done[r]["prob"] for r in rids]


@pytest.fixture(scope="module")
def trained():
    tr = _trainer("alpt")
    state, _ = _run(tr, 0, 2)
    return tr, state, DATA.batch("test", 0, 16)[0]


def test_degraded_serving_bitwise_equal_to_cache_off(trained):
    tr, state, ids = trained
    ref = _score(CTREngine.from_state(state, tr.cfg, batch=8), ids)
    faults.install(_plan(("cache.admission", (), True, None)))
    before = REG.snapshot()
    engine = CTREngine.from_state(state, tr.cfg, batch=8, cache_rows=4)
    assert _score(engine, ids) == ref
    m = engine.metrics()
    assert m.served_degraded == m.steps == 2 and m.retry_failures == 0
    health = engine.health()
    assert health["ready"] and health["served_degraded"] == 2
    assert m.caches[0].admission_oom == 2
    assert REG.snapshot().diff(before).value("engine.served_degraded", "ctr") == 2


def test_cold_tier_exhaustion_requeues_the_wave(trained):
    """The cold tier's gather fails 3 times at fetch wave 1 with 2 attempts
    per fetch: staging the second wave exhausts and ``RetryError`` leaves
    the engine loudly (a tier's exhaustion is no transient to the wave
    retry, as in the reference), the first wave back at the front of the
    queue; run again, the engine serves every probability of the
    fault-free run, and ``health()`` reports the exhaustion."""
    tr, state, ids = trained
    ref = _score(CTREngine.from_state(state, tr.cfg, batch=8), ids)
    faults.install(_plan(("cold.fetch", (1,), False, {"fails": 3, "attempts": 2})))
    engine = CTREngine.from_state(state, tr.cfg, batch=8, cache_rows=4, cold_tier=True)
    rids = [engine.submit(CTRRequest(ids=row)) for row in ids]
    with pytest.raises(faults.RetryError, match="cold.fetch"):
        engine.run()
    assert len(engine._queue) == len(ids) and engine.pending == len(ids)
    done = engine.run()
    assert [done[r]["prob"] for r in rids] == ref
    m = engine.metrics()
    assert (m.wave_retries, m.retry_failures) == (0, 0)
    cold = dict(engine._tier_retry_stats())["cold"]
    assert (cold.failures, cold.retries) == (1, 2)
    health = engine.health()
    assert not health["ready"] and health["checks"] == {
        "int8_resident": True, "within_budget": True, "no_retry_exhaustion": False}
    engine.reset_metrics()
    assert engine.health()["ready"]


def _flaky_rows(engine, fails):
    """Make the cold tier's wave read raise ``TransientFault`` ``fails``
    times, then read as before."""
    rows, left = engine.cold.rows, [fails]

    def flaky(flat_ids):
        if left[0] > 0:
            left[0] -= 1
            raise faults.TransientFault("injected wave failure")
        return rows(flat_ids)

    engine.cold.rows = flaky


def test_engine_wave_retry_requeues_and_stays_bitwise(trained):
    """Under a plan, a wave that raises a transient fault is run again from
    the front of the queue: every probability the fault-free run's, one
    wave retry counted, and the engine ready."""
    tr, state, ids = trained
    ref = _score(CTREngine.from_state(state, tr.cfg, batch=8), ids)
    faults.install(_plan(("cold.prefetch_loss", (99,), False, None)))
    before = REG.snapshot()
    engine = CTREngine.from_state(state, tr.cfg, batch=8, cache_rows=4, cold_tier=True)
    _flaky_rows(engine, 1)
    assert _score(engine, ids) == ref
    m = engine.metrics()
    assert (m.wave_retries, m.retry_failures, m.steps) == (1, 0, 2)
    assert engine.health()["ready"] and engine.health()["wave_retries"] == 1
    assert REG.snapshot().diff(before).value("faults.retries", "ctr.wave") == 1
    engine.reset_metrics()
    assert engine.metrics().wave_retries == 0


def test_engine_wave_exhaustion_is_loud(trained):
    tr, state, ids = trained
    faults.install(_plan(("cold.prefetch_loss", (99,), False, None)))
    engine = CTREngine.from_state(state, tr.cfg, batch=8, cache_rows=4, cold_tier=True)
    _flaky_rows(engine, 10)
    for row in ids:
        engine.submit(CTRRequest(ids=row))
    with pytest.raises(faults.RetryError, match="ctr.wave"):
        engine.run()
    assert engine.pending == len(ids) and len(engine._queue) == len(ids)  # nothing lost
    assert engine.retry_stats.failures == 1 and not engine.health()["ready"]
    assert engine.metrics().retry_failures == 1


def test_deadline_misses_count_every_wave_over_it(trained):
    tr, state, ids = trained
    before = REG.snapshot()
    engine = CTREngine.from_state(state, tr.cfg, batch=4)
    engine.deadline_s = 1e-9
    _score(engine, ids)
    m = engine.metrics()
    assert m.deadline_misses == m.steps == 4 and engine.health()["deadline_misses"] == 4
    assert REG.snapshot().diff(before).value("engine.deadline_misses", "ctr") == 4
    j = m.to_json()
    assert {k: j[k] for k in ("served_degraded", "deadline_misses", "wave_retries",
                              "retry_failures")} == {"served_degraded": 0, "deadline_misses": 4,
                                                     "wave_retries": 0, "retry_failures": 0}


def test_engine_without_a_plan_takes_no_retry_path(trained, monkeypatch):
    """No plan: the wave runs ``_advance`` directly (the retry helper is never
    called), no degraded-wave watch, the health ready."""
    from repro_torch.serving import engine as engine_mod

    def boom(*a, **k):
        raise AssertionError("retry path taken without a plan")

    monkeypatch.setattr(engine_mod, "retry_with_backoff", boom)
    tr, state, ids = trained
    engine = CTREngine.from_state(state, tr.cfg, batch=8, cache_rows=4, cold_tier=True)
    _score(engine, ids)
    assert engine.health()["ready"] and engine.metrics().served_degraded == 0


# ================================================================== kernels


def test_kernels_force_fallback_bitwise_and_counted():
    rs = np.random.RandomState(3)
    codes = torch.from_numpy(rs.randint(-127, 128, size=(16, 8)).astype(np.int8))
    step = torch.from_numpy(rs.uniform(0.01, 0.1, size=(16,)).astype(np.float32))
    ids = torch.tensor([0, 3, 3, 9, 15])
    want = ops.dequant_gather(codes, step, ids, use_kernel=False)
    faults.install(_plan(("kernels.force_fallback", (), True, None)))
    with ops.fallback_scope() as scope:
        assert torch.equal(ops.dequant_gather(codes, step, ids), want)
        ops.dequant_gather(codes, step, ids, use_kernel=False)  # asked for: not counted
    assert {(f["op"], f["reason"], f["count"]) for f in scope.stats()["fallbacks"]} == {
        ("dequant_gather", "fault-injected", 1)}
    # The ops param narrows the seam (the reference's names reach the
    # port's dispatchers of another name).
    faults.install(_plan(("kernels.force_fallback", (), True, {"ops": ["sr_round"]})))
    with ops.fallback_scope() as scope:
        assert torch.equal(ops.dequant_gather(codes, step, ids), want)
        ops.sr_round_seeded(torch.rand(4, 8), torch.full((4,), 0.01), 3)
    assert [f["op"] for f in scope.stats()["fallbacks"]] == ["sr_round_seeded"]
    faults.uninstall()
    with ops.fallback_scope() as scope:
        ops.dequant_gather(codes, step, ids)
    assert scope.stats()["total_fallbacks"] == 0


def test_force_fallback_over_a_training_step_counts_each_dispatch():
    """A plan forcing every op over 2 ALPT steps: the state and losses are
    the no-plan run's, and every dispatch of the step (gather, row step,
    line 5's sr_round, Adam) is counted once per step, fault-injected."""
    ref_tr = _trainer("alpt")
    ref_state, ref_losses = _run(ref_tr, 0, 2)
    faults.install(_plan(("kernels.force_fallback", (), True, None)))
    tr = _trainer("alpt")
    with ops.fallback_scope() as scope:
        state, losses = _run(tr, 0, 2)
    assert losses == ref_losses and _same(_leaves(tr, state), _leaves(ref_tr, ref_state))
    counts = {f["op"]: f["count"] for f in scope.stats()["fallbacks"]
              if f["reason"] == "fault-injected"}
    assert counts == {"dequant_gather": 2, "sparse_row_update_runs": 2, "sr_round": 2,
                      "adam_update": 2}, counts


# ===================================================================== CLIs


CTR_CLI = ["ctr", "--scale", "0.001", "--batch", "32", "--device", "cpu"]


def _json_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]), out


def test_injected_preemption_resumes_bitwise(tmp_path, capsys):
    """``train.preempt`` at step 2: exit 75 with a checkpoint at step 2; the
    requeued run resumes there, and its losses are the uninterrupted run's
    steps 3-4."""
    plan = tmp_path / "plan.json"
    _plan(("train.preempt", (2,), False, None)).save(plan)
    base = CTR_CLI + ["--steps", "4", "--ckpt-every", "1"]
    assert train_cli.main(base + ["--ckpt-dir", str(tmp_path / "ck"), "--fault-plan",
                                  str(plan)]) == 75
    out = capsys.readouterr().out
    assert "injected preemption at step 2" in out and "fault plan installed" in out
    assert faults.active_plan() is None  # the CLI uninstalled it
    assert train_cli.main(base + ["--ckpt-dir", str(tmp_path / "ck")]) == 0
    resumed, _ = _json_line(capsys)
    assert train_cli.main(base + ["--ckpt-dir", str(tmp_path / "ref")]) == 0
    ref, _ = _json_line(capsys)
    assert resumed["start_step"] == 2 and resumed["losses"] == ref["losses"][2:]


def test_train_cli_guard_turns_on_for_a_trainer_seam(tmp_path, capsys):
    plan = tmp_path / "plan.json"
    _plan(("trainer.nonfinite", (1,), False, None)).save(plan)
    assert train_cli.main(CTR_CLI + ["--steps", "3", "--fault-plan", str(plan)]) == 0
    report, out = _json_line(capsys)
    assert any("enabling --guard" in line for line in out)
    assert report["guard"] == {"steps": 3, "skipped": 1, "nonfinite_fired": 1, "delta_fired": 0,
                               "delta_clamped": 0}
    assert train_cli.main(CTR_CLI + ["--steps", "2", "--guard"]) == 0
    report, _ = _json_line(capsys)
    assert report["guard"]["skipped"] == 0
    assert train_cli.main(CTR_CLI + ["--steps", "2"]) == 0
    assert "guard" not in _json_line(capsys)[0]


def test_train_cli_reports_corrupt_checkpoints(tmp_path, capsys):
    ck = tmp_path / "ck"
    assert train_cli.main(CTR_CLI + ["--steps", "4", "--ckpt-dir", str(ck),
                                     "--ckpt-every", "2"]) == 0
    capsys.readouterr()
    faults.corrupt_checkpoint_leaf(ck, 4)
    assert train_cli.main(CTR_CLI + ["--steps", "5", "--ckpt-dir", str(ck)]) == 0
    report, _ = _json_line(capsys)
    assert report["corrupt_checkpoints"] == [4] and report["start_step"] == 2


def test_train_lm_cli_guard(tmp_path, capsys):
    """``train lm --guard`` with ``trainer.nonfinite`` at step 1: one skip;
    ``--guard`` with ``--dp-compress-bits`` refused."""
    plan = tmp_path / "plan.json"
    _plan(("trainer.nonfinite", (1,), False, None)).save(plan)
    lm = ["lm", "--arch", "smollm-135m", "--smoke", "--device", "cpu", "--batch", "2", "--seq",
          "16", "--log-every", "0"]
    assert train_cli.main(lm + ["--steps", "3", "--guard", "--fault-plan", str(plan)]) == 0
    report, _ = _json_line(capsys)
    assert report["guard"]["skipped"] == report["guard"]["nonfinite_fired"] == 1
    with pytest.raises(SystemExit) as ei:
        train_cli.main(lm + ["--steps", "1", "--guard", "--dp-compress-bits", "8"])
    assert ei.value.code == 2
    assert "single-program" in capsys.readouterr().err


def test_serve_cli_fault_flags(tmp_path, capsys):
    """``serve ctr`` through the cold tier with the cold seams and a deadline
    below a wave: the probabilities of the plain run, the JSON line (last on
    stdout) with the fault keys and ``health``, the recovery lines on
    stderr."""
    base = ["ctr", "--scale", "0.001", "--batch", "8", "--requests", "32", "--device", "cpu",
            "--cache-rows", "16", "--cold-tier"]
    assert serve_cli.main(base) == 0
    plain, plain_out = _json_line(capsys)
    plan = tmp_path / "plan.json"
    # The engine stages waves 1-3 (wave 0 is fetched on demand).
    _plan(("codestore.corrupt", (1,), False, None), ("cold.fetch", (2,), False, {"fails": 2}),
          ("cold.prefetch_loss", (3,), False, None)).save(plan)
    assert serve_cli.main(base + ["--fault-plan", str(plan), "--deadline-ms", "1e-6"]) == 0
    cap = capsys.readouterr()
    out = cap.out.strip().splitlines()
    report = json.loads(out[-1])
    assert [line for line in out if "first probs" in line] == [
        line for line in plain_out if "first probs" in line]
    assert report["deadline_misses"] == report["steps"] == 4
    assert report["health"]["ready"] and report["retry_failures"] == 0
    cold = report["caches"][0]
    assert (cold["corruption_detected"], cold["prefetch_dropped"]) == (1, 1)
    assert "[serve] health: READY" in cap.err and '"retries": 2' in cap.err
    assert "recovery: 1 admission refusals" not in cap.err
    assert plain["deadline_misses"] == 0 and plain["health"]["ready"]


def test_serve_lm_cli_deadline(capsys):
    assert serve_cli.main(["lm", "--arch", "smollm-135m", "--smoke", "--device", "cpu",
                           "--requests", "2", "--batch", "2", "--prompt-len", "8", "--gen", "2",
                           "--deadline-ms", "1e-6"]) == 0
    report, _ = _json_line(capsys)
    assert report["deadline_misses"] == report["steps"] > 0
    assert report["health"]["checks"]["no_retry_exhaustion"] and report["wave_retries"] == 0


def test_cold_tier_admissions_never_take_corrupted_staged_rows():
    """Every staged wave corrupted, each wave admitted before it is read (as
    the engine does): the hot tier takes its admissions from host memory, so
    later hits read true codes; every read bitwise the fault-free store's."""
    codes, step, rs = _cold_codes(5, n=48, d=8)
    waves = [rs.randint(0, 48, size=12) for _ in range(6)]

    def serve():
        store = _port_cold(codes, step, cache_rows=12)
        out = []
        for i, ids in enumerate(waves):
            store.admit(ids)
            out.append(store.rows(ids))
            if i + 1 < len(waves):
                store.stage(waves[i + 1])
        return out, store

    want, _ = serve()
    faults.install(_plan(("codestore.corrupt", (), True, None)))
    got, store = serve()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert store.corruption_detected == len(waves) - 1 and store.cache.hits > 0
