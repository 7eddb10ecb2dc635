"""Port parity for repro_torch.faults (plan, retry, guards), held against
repro.faults: the first half of tests/test_faults.py's contracts at its
CHAOS_DATA size, plus the plan's JSON crossing between the packages, the
backoff schedule and the checkpoint byte the reference picks, the guarded
CTR step at rung 2 against the reference's ``wrap_ctr_step``, and the LM
guard at the smoke config.

* Plans: JSON round trip both ways, duplicate sites refused, ``step_mask``
  the reference's schedule.
* Retry: the backoff schedule equal to the reference's, the applied sleeps
  and ``RetryStats`` equal, exhaustion loud (``RetryError`` chaining the
  cause, ``faults.retries`` / ``faults.retry_failures`` by registry diff),
  a real bug propagating at once.
* Guards: with no plan a guarded run is bitwise the unguarded one; an
  injected NaN or Delta blowup leaves every leaf of the state bitwise as it
  was before the step, the step counter and the generator advanced as in
  the unguarded run; the skip counts equal the injections; a finite Delta
  scale stays; under a cache the policy still observes a skipped wave.

The reference runs jitted on the CPU; the port takes its plain versions
here.  tests/test_torch_faults_sites.py has the storage, serving, kernel,
checkpoint and CLI seams.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro import methods as jmethods
from repro.core import alpt as jalpt
from repro.core import lpt as jlpt
from repro.core import quant as jq
from repro.faults import recovery as jrecovery
from repro.models import ctr as jctr
from repro.training import ctr_trainer as jtr
from repro_torch import faults, interop, methods
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import alpt as palpt
from repro_torch.core import lpt as plpt
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.faults import recovery
from repro_torch.models.ctr import DCNConfig
from repro_torch.obs import counters as obs_counters
from repro_torch.training import lm_trainer
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig, checkpoint_tree

pytestmark = pytest.mark.chaos

f32 = np.float32
CHAOS_DATA = CTRDatasetConfig(name="chaos", n_fields=4, cardinalities=(13, 29, 7, 53),
                              teacher_rank=2, seed=0)
DATA = CTRSynthetic(CHAOS_DATA)
DCN_KW = dict(n_fields=CHAOS_DATA.n_fields, emb_dim=8, cross_depth=1, mlp_widths=(16,))


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Plans are process-global in both packages: none leaks out of a test."""
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


def _spec_kw(method, *, n=CHAOS_DATA.n_features, d=8, bits=8, **extra):
    kw = dict(method=method, n=n, d=d, bits=bits, init_scale=0.05, **extra)
    if method.startswith("qr"):
        kw["hash_compression"] = 4.0
    if method == "mixed":
        q, r = divmod(n, 4)
        kw["field_cards"] = (q, q, q, q + r)
        kw["field_bits"] = (8, 4, 8, 2)
    return kw


def _trainer(method, *, guard=False, cache_rows=0, pad=False, **extra):
    spec = methods.EmbeddingSpec(**_spec_kw(method, pad_to_tiles=pad, **extra))
    return CTRTrainer(TrainerConfig(spec=spec, dcn=DCNConfig(**DCN_KW), guard=guard,
                                    cache_rows=cache_rows), device="cpu")


def _leaves(trainer, state):
    """Every leaf of the exported state's checkpoint tree (the generator's
    state included), as (path, tensor)."""
    return ckpt.flatten(checkpoint_tree(trainer.cfg, trainer.export_state(state)))


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        pa == pb and torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        for (pa, x), (pb, y) in zip(a, b))


def _finite(trainer, state) -> bool:
    return all(torch.isfinite(torch.as_tensor(x)).all() for _, x in _leaves(trainer, state)
               if torch.as_tensor(x).is_floating_point())


# ===================================================================== plan


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_plan_json_roundtrip_across_packages(tmp_path, writer):
    """A plan saved by either package loads in both, equal, with the same
    schedule and params."""
    specs = [("trainer.nonfinite", (3, 7), False, {}), ("cold.fetch", (2,), False, {"fails": 2}),
             ("kernels.force_fallback", (), True, {"ops": ["sr_round"]})]
    mods = {"port": faults, "reference": jfaults}
    w = mods[writer]
    plan = w.FaultPlan(seed=7, specs=tuple(w.FaultSpec(site=s, steps=st, always=a, params=p)
                                           for s, st, a, p in specs))
    path = tmp_path / "plan.json"
    plan.save(path)
    for mod in mods.values():
        loaded = mod.FaultPlan.load(path)
        assert loaded.to_json() == plan.to_json()
        assert loaded.fires("trainer.nonfinite", 3) and not loaded.fires("trainer.nonfinite", 4)
        assert loaded.fires("kernels.force_fallback", 12345)
        assert loaded.lookup("cold.fetch").param("fails") == 2
        assert loaded.lookup("no.such.site") is None and not loaded.fires("no.such.site", 0)
    assert faults.FaultPlan.load(path) == faults.FaultPlan.from_json(json.loads(path.read_text()))


def test_plan_duplicate_sites_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        faults.FaultPlan(specs=(faults.FaultSpec(site="cold.fetch", steps=(1,)),
                                faults.FaultSpec(site="cold.fetch", steps=(2,))))


def test_step_mask_matches_the_reference_schedule():
    """The port's host predicate fires where the reference's traced mask does."""
    for steps, always in (((1, 4), False), ((), False), ((), True)):
        spec = faults.FaultSpec(site="trainer.nonfinite", steps=steps, always=always)
        jspec = jfaults.FaultSpec(site="trainer.nonfinite", steps=steps, always=always)
        fire, jfire = faults.step_mask(spec), jfaults.step_mask(jspec)
        assert [fire(s) for s in range(7)] == [bool(jfire(jnp.int32(s))) for s in range(7)]
    assert not any(faults.step_mask(None)(s) for s in range(3))


def test_install_lookup_fires():
    assert faults.active_plan() is None and faults.lookup("cold.fetch") is None
    plan = faults.FaultPlan(specs=(faults.FaultSpec(site="cold.fetch", steps=(2,)),))
    faults.install(plan)
    assert faults.active_plan() is plan and faults.lookup("cold.fetch").steps == (2,)
    assert faults.fires("cold.fetch", 2) and not faults.fires("cold.fetch", 1)
    faults.install(None)
    assert not faults.fires("cold.fetch", 2)


# ==================================================================== retry


@pytest.mark.parametrize("attempts,base,factor,cap", [(4, 0.002, 2.0, 1.0), (1, 0.002, 2.0, 1.0),
                                                      (12, 0.5, 2.0, 1.0), (6, 0.003, 3.0, 0.05)])
def test_backoff_schedule_equals_the_reference(attempts, base, factor, cap):
    got = recovery.backoff_schedule(attempts, base, factor, cap)
    assert got == jrecovery.backoff_schedule(attempts, base, factor, cap)
    assert len(got) == max(0, attempts - 1) and all(s <= cap for s in got)


def _flaky(fails):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise faults.TransientFault("injected")
        return "ok"

    return fn, calls


def test_retry_succeeds_after_transients_with_the_reference_stats():
    """Two transient failures, then success: the port's sleeps and stats are
    the reference's on the same schedule, and the registry's
    ``faults.retries`` grows by the retries."""
    reg = obs_counters.registry()
    before = reg.snapshot()
    out = {}
    for mod, rec in ((faults, recovery), (jfaults, jrecovery)):
        fn, calls = _flaky(2)
        if mod is jfaults:  # the reference retries its own InjectedFault
            def fn(fn=fn):
                try:
                    return fn()
                except faults.TransientFault as e:
                    raise jfaults.TransientFault(str(e)) from None
        stats, sleeps = mod.RetryStats(), []
        assert rec.retry_with_backoff(fn, op="t", attempts=4, base_s=0.002, stats=stats,
                                      sleep=sleeps.append) == "ok"
        assert calls["n"] == 3
        out[mod] = (stats.to_json(), sleeps)
    assert out[faults] == out[jfaults]
    assert tuple(out[faults][1]) == recovery.backoff_schedule(4, 0.002)[:2]
    assert out[faults][0] == {"calls": 1, "retries": 2, "failures": 0,
                              "backoff_s": sum(out[faults][1])}
    assert reg.snapshot().diff(before).value("faults.retries", "t") == 2


def test_retry_exhaustion_is_loud():
    reg = obs_counters.registry()
    before = reg.snapshot()
    stats = faults.RetryStats()

    def doomed():
        raise faults.TransientFault("always")

    with pytest.raises(faults.RetryError, match="failed after 3 attempts") as ei:
        recovery.retry_with_backoff(doomed, op="x", attempts=3, base_s=0.0, stats=stats,
                                    sleep=lambda s: None)
    assert isinstance(ei.value.__cause__, faults.TransientFault)
    assert ei.value.op == "x" and ei.value.attempts == 3
    assert (stats.failures, stats.retries, stats.calls) == (1, 2, 1)
    delta = reg.snapshot().diff(before)
    assert delta.value("faults.retry_failures", "x") == 1 and delta.value("faults.retries", "x") == 2
    with pytest.raises(ValueError, match="attempts"):
        recovery.retry_with_backoff(doomed, op="x", attempts=0)


@pytest.mark.parametrize("exc", [ValueError, KeyError, RuntimeError])
def test_retry_real_bugs_propagate_immediately(exc):
    stats = faults.RetryStats()

    def bug():
        raise exc("not transient")

    with pytest.raises(exc):
        recovery.retry_with_backoff(bug, op="t", attempts=5, stats=stats, sleep=lambda s: None)
    assert stats.retries == 0 and stats.failures == 0


def test_retry_stats_json_is_the_references():
    a = faults.RetryStats(calls=4, retries=3, failures=1, backoff_s=0.75)
    assert a.to_json() == {"calls": 4, "retries": 3, "failures": 1, "backoff_s": 0.75}
    assert list(a.to_json()) == list(jfaults.RetryStats().to_json())


@pytest.mark.parametrize("step,leaf,seed", [(2, 0, 0), (7, 1, 3), (12, 2, 11)])
def test_corrupt_checkpoint_leaf_flips_the_reference_byte(tmp_path, step, leaf, seed):
    """On two copies of one committed leaf, the port and the reference flip
    the same byte."""
    for who in ("port", "ref"):
        d = tmp_path / who / f"step_{step:09d}"
        d.mkdir(parents=True)
        for i in range(leaf + 1):
            np.save(d / f"leaf_{i:05d}.npy", np.random.RandomState(i).randn(40).astype(f32))
    p = faults.corrupt_checkpoint_leaf(tmp_path / "port", step, leaf=leaf, seed=seed)
    r = jfaults.corrupt_checkpoint_leaf(tmp_path / "ref", step, leaf=leaf, seed=seed)
    assert p.read_bytes() == r.read_bytes()
    clean = np.random.RandomState(leaf).randn(40).astype(f32)
    np.save(tmp_path / "clean.npy", clean)
    flipped = np.flatnonzero(np.frombuffer(p.read_bytes(), np.uint8)
                             != np.frombuffer((tmp_path / "clean.npy").read_bytes(), np.uint8))
    assert flipped.size == 1 and flipped[0] >= 128


# =================================================================== guards


GUARD_METHODS = ["alpt", "lpt", "qr_alpt", "mixed", "fp", "prune"]


def _run(trainer, steps, state=None):
    state = trainer.init_state() if state is None else state
    losses = []
    for i in range(state.step, state.step + steps):
        state, m = trainer.train_step(state, *DATA.batch("train", i, 32))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("method", GUARD_METHODS)
def test_guard_without_a_plan_is_bitwise_unguarded(method):
    """``guard=True`` and no plan: the same losses and every leaf (the
    generator's state included), and no step skipped."""
    pad = method == "alpt"
    a, b = _trainer(method, pad=pad), _trainer(method, guard=True, pad=pad)
    sa, la = _run(a, 4)
    sb, lb = _run(b, 4)
    assert la == lb and _same(_leaves(a, sa), _leaves(b, sb))
    assert b.guard_stats.to_json() == {"steps": 4, "skipped": 0, "nonfinite_fired": 0,
                                       "delta_fired": 0, "delta_clamped": 0}
    assert a.guard_stats is None


@pytest.mark.parametrize("method,pad", [("alpt", True), ("alpt", False), ("lpt", False),
                                        ("qr_alpt", False), ("mixed", True), ("fp", False),
                                        ("prune", False)])
def test_guard_skip_count_matches_injected_nan_count(method, pad):
    """``trainer.nonfinite`` at steps 1 and 3: each fired step leaves every
    leaf as it was before it, the step counter advanced and the generator
    where the unguarded run has it; skipped == fired == 2; the state stays
    finite.  Prune's schedule clock is the host refresh's, which wraps the
    guard (as in the reference) and follows the step counter."""
    clocks = {".step", ".generator"} | ({".emb_state.step"} if method == "prune" else set())
    ref = _trainer(method, pad=pad)
    rs = ref.init_state()
    gens = []
    for i in range(5):
        rs, _ = ref.train_step(rs, *DATA.batch("train", i, 32))
        gens.append(rs.generator.get_state())
    faults.install(faults.FaultPlan(specs=(faults.FaultSpec(site="trainer.nonfinite",
                                                            steps=(1, 3)),)))
    tr = _trainer(method, guard=True, pad=pad)  # the seams bind at construction
    state = tr.init_state()
    for i in range(5):
        before = _leaves(tr, state)
        state, m = tr.train_step(state, *DATA.batch("train", i, 32))
        assert state.step == i + 1 and torch.equal(state.generator.get_state(), gens[i])
        assert m["guard_skipped"] == m["fault_nonfinite_fired"] == int(i in (1, 3))
        if i in (1, 3):
            after = _leaves(tr, state)
            changed = {pa for (pa, x), (_, y) in zip(before, after)
                       if not torch.equal(torch.as_tensor(x), torch.as_tensor(y))}
            assert changed <= clocks, changed
    assert tr.guard_stats.skipped == tr.guard_stats.nonfinite_fired == 2
    assert _finite(tr, state)


def test_alpt_delta_blowup_recovered_by_skip_step():
    """``alpt.delta`` (default scale inf) at step 2: one skip, the state
    finite, Delta as it was before the step."""
    faults.install(faults.FaultPlan(specs=(faults.FaultSpec(site="alpt.delta", steps=(2,)),)))
    tr = _trainer("alpt", guard=True)
    state, _ = _run(tr, 2)
    delta = state.emb_state.step.clone()
    state, _ = _run(tr, 1, state)
    assert torch.equal(state.emb_state.step, delta)
    state, _ = _run(tr, 1, state)
    assert tr.guard_stats.delta_fired == 1 and tr.guard_stats.skipped == 1
    assert _finite(tr, state)


def test_alpt_delta_finite_scale_stays_in_the_state():
    """A finite scale does not trip the guard: the scaled Delta stays, rows
    the batch did not touch included (as in the reference)."""
    faults.install(faults.FaultPlan(specs=(faults.FaultSpec(site="alpt.delta", steps=(1,),
                                                            params={"scale": 2.0}),)))
    tr = _trainer("alpt", guard=True)
    state, _ = _run(tr, 1)
    delta = state.emb_state.step.clone()
    ids, labels = DATA.batch("train", 1, 32)
    state, m = tr.train_step(state, ids, labels)
    assert m["guard_skipped"] == 0 and m["fault_delta_fired"] == 1
    untouched = np.setdiff1d(np.arange(CHAOS_DATA.n_features), ids.ravel())
    assert untouched.size > 0
    torch.testing.assert_close(state.emb_state.step[untouched], delta[untouched] * 2.0,
                               rtol=0, atol=0)


def test_alpt_step_clamp_bounds_finite_blowup():
    """ALPT's ``step_clamp`` (the bound of a finite blowup): the rows and the
    ``delta_clamped`` count equal the reference's, and GuardStats adds it."""
    clamp = 0.005
    table = jlpt.init_table(jax.random.PRNGKey(0), 16, 8, 8, step_size=0.01, optimizer="sgd")
    ids = jnp.array([1, 2, 3])
    c = jax.random.normal(jax.random.PRNGKey(1), (3, 8))
    jcfg = jalpt.ALPTConfig(bits=8, optimizer="sgd", step_lr=1e-3, step_clamp=clamp)
    key = jax.random.PRNGKey(2)
    jnew, _, jaux = jax.jit(lambda t: jalpt.alpt_step(
        t, ids, lambda rows: jnp.sum(rows * c), cfg=jcfg, lr=0.05, noise_key=key))(table)
    pt = plpt.LPTTable(codes=plpt.CodeStore.from_codes(torch.from_numpy(np.array(table.codes.data)), 8),
                       step=torch.from_numpy(np.array(table.step)),
                       mu=torch.from_numpy(np.array(table.mu)),
                       nu=torch.from_numpy(np.array(table.nu)), count=int(table.count))
    tc = torch.from_numpy(np.array(c))
    rows = plpt.lookup(pt, torch.tensor([1, 2, 3])).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(rows * tc), [rows])
    noise = (torch.from_numpy(np.array(jq.sr_noise(key, (3, 8)))),
             torch.from_numpy(np.array(jq.sr_noise(jax.random.fold_in(key, 1), (3, 8)))))
    pcfg = palpt.ALPTConfig(bits=8, optimizer="sgd", step_lr=1e-3, step_clamp=clamp)
    pnew, paux = palpt.alpt_step(pt, torch.tensor([1, 2, 3]), g, lambda r: torch.sum(r * tc),
                                 cfg=pcfg, lr=0.05, noise=noise)
    assert int(paux["delta_clamped"]) == int(jaux["delta_clamped"]) == 3
    assert float(pnew.step[1:4].max()) <= clamp
    np.testing.assert_array_equal(pnew.step.numpy(), np.array(jnew.step))
    stats = faults.GuardStats()
    stats.observe({"loss": 0.0, **paux})
    stats.observe({"guard_skipped": 1})
    assert stats.to_json() == {"steps": 2, "skipped": 1, "nonfinite_fired": 0, "delta_fired": 0,
                               "delta_clamped": 3}


def test_guard_stats_publish_to_gauges():
    stats = faults.GuardStats()
    stats.observe({"guard_skipped": torch.tensor(1), "fault_nonfinite_fired": 1,
                   "delta_clamped": torch.tensor(4)})
    stats.publish()
    reg = obs_counters.registry()
    assert reg.gauge("faults.guard.skipped").value() == 1
    assert reg.gauge("faults.guard.delta_clamped").value() == 4
    assert reg.gauge("faults.guard.steps").value() == 1
    assert faults.guards.GUARD_METRIC_KEYS == jfaults.guards.GUARD_METRIC_KEYS


def test_guard_under_a_cache_keeps_the_policy_observing():
    """A cached, guarded run with two NaN steps: the policy observes every
    wave as the unguarded cached run's does (equal counters), and the
    exported state holds every leaf as the uncached guarded run's."""
    plan = faults.FaultPlan(specs=(faults.FaultSpec(site="trainer.nonfinite", steps=(1, 3)),))
    faults.install(plan)
    cached = _trainer("alpt", guard=True, cache_rows=6)
    plain = _trainer("alpt", guard=True)
    sc, lc = _run(cached, 6)
    sp, lp = _run(plain, 6)
    assert math.isnan(lc[1]) and math.isnan(lc[3])
    np.testing.assert_array_equal(lc, lp)
    assert _same(_leaves(cached, sc), _leaves(plain, sp))
    faults.uninstall()
    ref = _trainer("alpt", cache_rows=6)
    _run(ref, 6)
    assert cached.cache_stats() == ref.cache_stats()
    assert sum(s["hits"] for s in cached.cache_stats()) > 0
    assert cached.guard_stats.skipped == 2


@pytest.mark.parametrize("method", ["alpt", "lpt"])
def test_guarded_ctr_step_equals_the_reference_guard(method):
    """Rung 2: the reference's ``wrap_ctr_step`` and the port's around one
    row step (a linear loss in the rows, so the row gradient is exact; the
    dense params are read only by the guard), from the same state with the
    reference's SR noise, under one plan (``trainer.nonfinite`` at step 1,
    ``alpt.delta`` at step 2): after each of 4 steps the embedding state is
    bitwise the reference's, and the skips are the reference's."""
    kw = _spec_kw(method)
    jspec, pspec = jmethods.EmbeddingSpec(**kw), methods.EmbeddingSpec(**kw)
    jm, pm = jmethods.get(method), methods.get(method)
    jemb = jax.jit(lambda k: jm.init(k, jspec))(jax.random.PRNGKey(5))
    pcfg = TrainerConfig(spec=pspec, dcn=DCNConfig(**DCN_KW))
    jdense = jtr.CTRTrainer(jtr.TrainerConfig(spec=jspec, model="dcn",
                                              dcn=jctr.DCNConfig(**DCN_KW))).init_state().dense_params
    specs = (("trainer.nonfinite", (1,)), ("alpt.delta", (2,)))
    jfaults.install(jfaults.FaultPlan(specs=tuple(jfaults.FaultSpec(site=s, steps=st)
                                                  for s, st in specs)))
    faults.install(faults.FaultPlan(specs=tuple(faults.FaultSpec(site=s, steps=st)
                                                for s, st in specs)))
    lr = f32(3e-3)

    def jstep(s, ids, wts):
        rng, kn = jax.random.split(s.rng)
        emb, dense, _, m = jm.fused_row_step(
            s.emb_state, ids, spec=jspec, loss_from_rows=lambda r, p: jnp.sum(r * wts),
            dense_params=s.dense_params, dense_opt=None, update_dense=lambda g, o, p: (p, o),
            lr=lr, weight_decay=5e-8, noise_key=kn)
        return s._replace(emb_state=emb, dense_params=dense, step=s.step + 1, rng=rng), m

    jguarded = jfaults.wrap_ctr_step(jax.jit(jstep))
    js = jtr.TrainState(emb_state=jemb, dense_params=jdense, dense_opt=None, emb_opt=None,
                        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(9))
    ps = interop.state_from_numpy(pcfg, emb_state=_to_np(jemb),
                                  dense_params=jax.tree.map(np.array, jdense), device="cpu")
    draws = {}

    def pstep(s, ids, wts, **_):
        tw = torch.from_numpy(wts)
        emb, m = pm.fused_row_step(s.emb_state, torch.from_numpy(ids), spec=pspec,
                                   loss_from_rows=lambda r: torch.sum(r * tw), dense_params=[],
                                   update_dense=lambda g: None, lr=float(lr), weight_decay=5e-8,
                                   noise=draws["noise"])
        return s._replace(emb_state=emb, step=s.step + 1), m

    pguarded = faults.wrap_ctr_step(pstep, method=pm, spec=pspec)
    rs = np.random.RandomState(1)
    for i in range(4):
        ids, _ = DATA.batch("train", i, 16)
        wts = (rs.randn(*ids.shape, 8) * 0.3).astype(f32)
        kn = jax.random.split(js.rng)[1]
        draws["noise"] = _reference_draws(method, kn, (ids.size, pspec.d_padded))
        js, jmet = jguarded(js, jnp.asarray(ids), jnp.asarray(wts))
        ps, pmet = pguarded(ps, ids, wts)
        assert pmet["guard_skipped"] == int(jmet["guard_skipped"]) == int(i in (1, 2))
        assert pmet["fault_delta_fired"] == int(jmet["fault_delta_fired"])
        want, got = _to_np(js.emb_state), interop.emb_state_to_numpy(ps.emb_state)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(ps.dense.jax_params()), jax.tree.leaves(js.dense_params),
                        strict=True):
            np.testing.assert_array_equal(a, np.array(b))
        assert ps.step == int(js.step) == i + 1


def _reference_draws(method, key, shape):
    def sr(k):
        return torch.from_numpy(np.array(jq.sr_noise(k, shape)))

    if method == "lpt":
        return [sr(key)]
    return [sr(key), sr(jax.random.fold_in(key, 1))]


def _to_np(x):
    if hasattr(x, "_asdict"):
        return {k: _to_np(v) for k, v in x._asdict().items()}
    if hasattr(x, "data") and hasattr(x, "packed"):
        return np.array(x.data)
    if isinstance(x, (tuple, list)):
        return [_to_np(v) for v in x]
    if isinstance(x, (int, float)):
        return x
    return np.array(x)


# ======================================================================= LM


def _lm_leaves(cfg, state):
    """Every leaf of an LM state's checkpoint tree (the generator's state
    included), as (path, tensor)."""
    return ckpt.flatten(lm_trainer.checkpoint_tree(cfg, state))


def test_lm_guard_at_the_smoke_config():
    """SmolLM's smoke config, ALPT-8, 4 steps: guarded with no plan ==
    unguarded bitwise; ``trainer.nonfinite`` at step 1 and ``alpt.delta`` at
    step 2: those steps leave every leaf (params, their Adam state, the
    table, its slots) as before, the generator where the unguarded run has
    it; the other steps equal the unguarded run's from the same state."""
    from repro_torch import configs
    from repro_torch.data.lm_synth import LMTokenStream

    cfg = configs.smoke_config("smollm-135m")
    data = LMTokenStream(cfg.vocab_size, 32, seed=17)

    def batch(i):
        full = torch.from_numpy(data.batch(i, 2))
        return {"tokens": full[:, :-1], "labels": full[:, 1:]}

    def run(guard, n=4):
        tcfg = lm_trainer.LMTrainerConfig(guard=guard)
        step = lm_trainer.make_train_step(cfg, tcfg)
        state = lm_trainer.init_state(cfg, tcfg, seed=0, device="cpu")
        out, stats = [], faults.GuardStats()
        for i in range(n):
            state, m = step(state, batch(i))
            out.append((_lm_leaves(cfg, state), float(m["loss"])))
            stats.observe(m)
        return out, stats

    plain, _ = run(False)
    guarded, stats = run(True)
    assert all(_same(a, b) and la == lb for (a, la), (b, lb) in zip(plain, guarded))
    assert stats.skipped == 0
    faults.install(faults.FaultPlan(specs=(faults.FaultSpec(site="trainer.nonfinite", steps=(1,)),
                                           faults.FaultSpec(site="alpt.delta", steps=(2,)))))
    chaos, stats = run(True)
    assert stats.to_json() == {"steps": 4, "skipped": 2, "nonfinite_fired": 1, "delta_fired": 1,
                               "delta_clamped": 0}
    for i in (1, 2):
        changed = {p for (p, x), (_, y) in zip(chaos[i - 1][0], chaos[i][0])
                   if not torch.equal(torch.as_tensor(x), torch.as_tensor(y))}
        assert changed <= {".step", ".generator"}, changed
        gen = dict(chaos[i][0])[".generator"]
        assert torch.equal(gen, dict(plain[i][0])[".generator"])
    assert _same(chaos[0][0], plain[0][0])
    assert all(math.isfinite(x) for x in (chaos[0][1], chaos[3][1]))
