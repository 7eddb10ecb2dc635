"""Port parity for the storage tiers (repro_torch.storage), the port of
tests/test_storage.py at its sizes.

* The row surface: ``TieredCodes`` over int8 and packed 4- and 2-bit
  stores reads and writes the logical codes a plain store holds.
* The policy: the port's ``HotRowCache`` makes the reference's moves, array
  for array, and keeps its counters, on the same id streams.
* Training: cache on == cache off, bitwise, for every integer-table method
  at 8 and 4 bits, through the dirty write-back cycle and a resume; the
  port's cached row steps against the reference's cached ones, bitwise,
  given its noise and a linear loss (rung 2); the cached trainer against
  the reference's over 6 steps (rung 3, as tests/test_torch_train.py).
* Serving: hot and cold tiers score bitwise as the uncached engine, the
  policy's counters equal the reference engine's, a tier over its budget is
  refused; resident bytes count the maps; the metrics keep the reference's
  schema.
* The routed plain versions equal the untiered ones over the logical table.

The reference runs jitted on the CPU; the port takes its plain versions
here (CPU tensors).  The kernels are held against those plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 11).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import methods as jmethods
from repro.core import quant as jq
from repro.models import ctr as jctr
from repro.serving.ctr import CTREngine as JEngine
from repro.serving.ctr import CTRRequest as JRequest
from repro.serving.engine import CacheMetrics as JCacheMetrics
from repro.storage.tiered import HotRowCache as JHotRowCache
from repro.training import ctr_trainer as jtr
from repro_torch import interop, methods
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import quant
from repro_torch.core.codestore import CodeStore
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.ctr import DCNConfig
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.serving.engine import CacheMetrics, EngineMetrics
from repro_torch.core.tiered import TieredCodes
from repro_torch.storage.tiered import HotRowCache
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig, checkpoint_tree

f32 = np.float32
INT_METHODS = ["lpt", "alpt", "qr_lpt", "qr_alpt", "mixed"]
ZIPF_DATA = CTRDatasetConfig(name="storage-zipf", n_fields=4, cardinalities=(13, 17, 11, 23),
                             teacher_rank=3, zipf_a=1.1, seed=5)
DATA = CTRSynthetic(ZIPF_DATA)
DCN_KW = dict(n_fields=4, emb_dim=8, cross_depth=1, mlp_widths=(16,))


def _spec_kw(method, *, n=ZIPF_DATA.n_features, d=8, bits=8):
    kw = dict(method=method, n=n, d=d, bits=bits, init_scale=0.05)
    if method.startswith("qr"):
        kw["hash_compression"] = 4.0
    if method == "mixed":
        # Four field groups at mixed widths over the n-row table.
        q, r = divmod(n, 4)
        kw["field_cards"] = (q, q, q, q + r)
        kw["field_bits"] = (8, 4, 8, 2)
    return kw


def _trainer(method, *, cache_rows, bits=8, use_kernels=True):
    spec = methods.EmbeddingSpec(**_spec_kw(method, bits=bits), use_kernels=use_kernels)
    cfg = TrainerConfig(spec=spec, dcn=DCNConfig(**DCN_KW), lr=1e-3, cache_rows=cache_rows)
    return CTRTrainer(cfg, device="cpu")


def _train(trainer, steps, batch=16, state=None, batches=None):
    state = trainer.init_state() if state is None else state
    losses = []
    for i in range(state.step, state.step + steps):
        ids, labels = DATA.batch("train", i, batch) if batches is None else batches[i]
        state, m = trainer.train_step(state, ids, labels)
        losses.append(float(m["loss"]))
    return state, losses


def _same_tree(a, b) -> bool:
    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    return all(torch.equal(torch.as_tensor(x).detach(), torch.as_tensor(y).detach())
               for (_, x), (_, y) in zip(fa, fb))


# ------------------------------------------------------------- row surface


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_rowstore_conformance_tiered(bits):
    """TieredCodes reads and writes the logical codes a plain store holds
    (int8 and packed containers), through the surface ``CodeStore`` has;
    writes route per id; flush and unwrap fold the hot tier."""
    rs = np.random.RandomState(bits)
    lo, hi = quant.code_bounds(bits)
    codes = torch.from_numpy(rs.randint(lo, hi + 1, (32, 8)).astype(np.int8))
    cache = HotRowCache(4, 32, name="t")
    tiered = cache.wrap(CodeStore.from_codes(codes.clone(), bits))
    assert tiered.shape == (32, 8)
    assert tiered.packed == (bits < 8)
    # Admit rows {3, 7} so the hot overlay is read.
    tiered = cache.observe_apply(tiered, np.array([3, 7, 3, 7, 3, 7]))
    assert cache.rows_cached == 2 and torch.equal(tiered.slots_for(torch.tensor([3, 7, 5, 40, -1])),
                                                  torch.tensor([0, 1, -1, -1, -1]))
    ids = torch.tensor([0, 3, 7, 31, 3])
    assert torch.equal(tiered.take(ids), codes[ids])
    assert torch.equal(tiered.take(ids.reshape(5, 1)), codes[ids].reshape(5, 1, 8))
    assert torch.equal(tiered.unpack(), codes)

    # Writes route: cached rows to the hot tier only, the others to the
    # backing; an id past the table is dropped.
    new_rows = torch.from_numpy(rs.randint(lo, hi + 1, (4, 8)).astype(np.int8))
    w_ids = torch.tensor([3, 5, 7, 32])
    assert tiered.set_rows(w_ids, new_rows) is tiered
    want = codes.clone()
    want[[3, 5, 7]] = new_rows[:3]
    assert torch.equal(tiered.unpack(), want)
    assert torch.equal(tiered.take(ids), want[ids])
    assert torch.equal(tiered.backing.unpack()[[3, 7]], codes[[3, 7]])  # not written back yet
    assert torch.equal(tiered.backing.unpack()[5], want[5])
    cache.observe(np.array([3, 7]), write=True)  # the policy marks the written rows dirty
    assert torch.equal(cache.unwrap(tiered).unpack(), want)
    assert torch.equal(tiered.backing.unpack()[[3, 7]], codes[[3, 7]])  # unwrap copies

    mask = torch.zeros(32, dtype=torch.bool)
    mask[[3, 9]] = True
    repl = torch.from_numpy(rs.randint(lo, hi + 1, (32, 8)).astype(np.int8))
    t3 = tiered.where_rows(mask, repl)
    want3 = torch.where(mask[:, None], repl, want)
    assert torch.equal(t3.unpack(), want3)
    assert torch.equal(t3.hot.unpack()[0], repl[3])  # both tiers take a selected row

    # A plain store given the same writes holds the same codes.
    plain = CodeStore.from_codes(codes.clone(), bits)
    assert plain.set_rows(w_ids, new_rows) is plain
    assert torch.equal(plain.unpack(), want) and torch.equal(plain.take(ids), tiered.take(ids))
    width = tiered.backing.data.shape[1]
    assert plain.resident_bytes == 32 * width
    assert tiered.resident_bytes == 32 * width + 4 * width + (32 + 4) * 4

    # The dirty rows survive a flush into the backing.
    cache.flush(tiered)
    assert torch.equal(tiered.backing.unpack(), want) and not cache.dirty.any()


# ------------------------------------------------------------------ policy


@pytest.mark.parametrize("seed", range(6))
def test_hot_row_cache_moves_equal_the_reference(seed):
    """The port's policy against the reference's on the same id streams
    (Zipf traffic, reads and writes, ids of other slots, a warm start):
    identical move arrays (dtypes included), counters, maps and flags; the
    same rows move on the device."""
    rs = np.random.RandomState(seed)
    n = int(rs.randint(40, 400))
    cap = int(rs.randint(1, 48))
    j, p = JHotRowCache(cap, n, name="s"), HotRowCache(cap, n, name="s")
    d = 4
    base = rs.randint(-128, 128, (n, d)).astype(np.int8)
    jt = j.wrap(jnp.asarray(base))
    pt = p.wrap(CodeStore.from_codes(torch.from_numpy(base.copy()), 8))
    if seed % 2:
        freqs = rs.randint(0, 4, n)
        jt = j.warm_start(jt, freqs)
        pt = p.warm_start(pt, freqs)
    for step in range(40):
        ids = (rs.zipf(1.05 + 0.1 * (seed % 3), rs.randint(0, 80)) - 1) % (n + 5) - rs.randint(2)
        write = bool(rs.randint(2))
        mj, mp = j.observe(ids, write=write), p.observe(ids, write=write)
        assert (mj is None) == (mp is None), step
        if mj is not None:
            for a, b in zip(mj, mp):
                assert a.dtype == b.dtype and np.array_equal(a, b), step
            jt = j.apply(jt, mj)
            pt = p.apply(pt, mp)
            if write:  # the row step writes cached rows to the hot tier
                new = rs.randint(-128, 128, (cap, d)).astype(np.int8)
                jt = dataclasses.replace(jt, hot=jnp.asarray(new))
                pt.hot.data.copy_(torch.from_numpy(new))
        assert j.stats() == p.stats() and j.rows_cached == p.rows_cached
        assert np.array_equal(j.slot_of_arr, p.slot_of_arr)
        assert np.array_equal(j.last_used, p.last_used) and np.array_equal(j.dirty, p.dirty)
    assert j.host_metadata_bytes == p.host_metadata_bytes
    np.testing.assert_array_equal(np.asarray(jt.slot_of_id), pt.slot_of_id.numpy())
    np.testing.assert_array_equal(np.asarray(jt.ids_of_slot), pt.ids_of_slot.numpy())
    np.testing.assert_array_equal(np.asarray(j.unwrap(jt)), p.unwrap(pt).data.numpy())
    np.testing.assert_array_equal(np.asarray(j.flush(jt).backing), p.flush(pt).backing.data.numpy())
    assert j.stats() == p.stats()


def test_hot_row_cache_evicts_across_a_batch_like_the_reference():
    """A full cache under heavy misses: victims taken in (last use, slot)
    order across one batch, ties to the lowest slot, the batch stopped at
    the first miss that loses, and slot 0 once every slot was touched."""
    j, p = JHotRowCache(6, 50), HotRowCache(6, 50)
    streams = [np.arange(6), np.arange(6), np.array([0, 1, 2]),
               np.array([10, 10, 11, 11, 12, 12, 13, 13, 14]), np.array([10, 11, 12, 13, 20] * 3),
               np.arange(6), np.array([30, 30, 30, 31, 31, 31, 32])]
    for ids in streams:
        mj, mp = j.observe(ids, write=True), p.observe(ids, write=True)
        assert (mj is None) == (mp is None)
        if mj is not None:
            assert all(np.array_equal(a, b) for a, b in zip(mj, mp))
    assert j.stats() == p.stats() and p.evictions > 0 and p.writebacks > 0


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("method", INT_METHODS)
def test_train_parity_cache_on_equals_off(method, bits):
    """Cache-on training is bitwise cache-off: the losses and every leaf of
    the exported state (codes, Delta, moments, dense params, optimizer
    state, generator); the cache served hits."""
    off, l_off = _train(_trainer(method, cache_rows=0, bits=bits), 6)
    tr = _trainer(method, cache_rows=8, bits=bits)
    on, l_on = _train(tr, 6)
    assert l_on == l_off
    cfg = tr.cfg
    assert _same_tree(checkpoint_tree(cfg, tr.export_state(on)), checkpoint_tree(cfg, off))
    assert any(s["hits"] > 0 for s in tr.cache_stats())
    assert {s["name"] for s in tr.cache_stats()} == {s.name for s in tr.method.storage_spec(
        tr.spec)}


def test_train_parity_holds_with_the_kernels_off():
    """The plain paths (``use_kernels=False``) route through the tiers too."""
    off, l_off = _train(_trainer("alpt", cache_rows=0, use_kernels=False), 4)
    tr = _trainer("alpt", cache_rows=8, use_kernels=False)
    on, l_on = _train(tr, 4)
    assert l_on == l_off
    assert _same_tree(checkpoint_tree(tr.cfg, tr.export_state(on)), checkpoint_tree(tr.cfg, off))


def test_dirty_writeback_cycle():
    """A written row survives evict -> re-admit: phase A writes rows {0, 1}
    dirty into a 2-row cache, phase B hammers {2, 3} until they overtake
    (dirty eviction + write-back), phase C returns to {0, 1}.  The exported
    state equals cache-off exactly."""
    rng = np.random.RandomState(7)
    phases = [(0, 1)] * 3 + [(2, 3)] * 6 + [(0, 1)] * 5
    batches = []
    for a, b in phases:
        ids = np.where(np.arange(32).reshape(8, 4) % 2 == 0, a, b)
        batches.append((ids.astype(np.int32), rng.randint(0, 2, 8).astype(np.float32)))
    off, l_off = _train(_trainer("alpt", cache_rows=0), len(batches), batches=batches)
    tr = _trainer("alpt", cache_rows=2)
    on, l_on = _train(tr, len(batches), batches=batches)
    assert l_on == l_off
    assert _same_tree(checkpoint_tree(tr.cfg, tr.export_state(on)), checkpoint_tree(tr.cfg, off))
    stats = tr.cache_stats()[0]
    assert stats["evictions"] > 0 and stats["writebacks"] > 0


def test_trainer_refuses_a_cache_without_slots():
    with pytest.raises(ValueError, match="no cacheable storage slots"):
        _trainer("lsq", cache_rows=8)
    assert methods.get("fp").storage_spec(methods.EmbeddingSpec("fp", n=8, d=4)) == ()


def test_resume_under_a_cache_is_bitwise(tmp_path):
    """6 steps straight under a cache against 3, a save, a fresh cache-on
    trainer's restore (empty caches) and 3 more: the same losses and
    exported state; every saved leaf file byte for byte a cache-off run's."""
    straight_tr = _trainer("qr_alpt", cache_rows=8, bits=4)
    straight, l_straight = _train(straight_tr, 6)
    tr = _trainer("qr_alpt", cache_rows=8, bits=4)
    state, l1 = _train(tr, 3)
    manager = CheckpointManager(tmp_path / "on", save_every=3)
    assert tr.save(manager, state) and not tr.save(manager, state._replace(step=4))
    fresh = _trainer("qr_alpt", cache_rows=8, bits=4)
    restored = fresh.restore(manager)
    assert restored.step == 3 and all(s["rows_cached"] == 0 for s in fresh.cache_stats())
    assert isinstance(restored.emb_state.remainder.codes, TieredCodes)
    resumed, l2 = _train(fresh, 3, state=restored)
    assert l1 + l2 == l_straight
    cfg = tr.cfg
    assert _same_tree(checkpoint_tree(cfg, fresh.export_state(resumed)),
                      checkpoint_tree(cfg, straight_tr.export_state(straight)))
    off_tr = _trainer("qr_alpt", cache_rows=0, bits=4)
    off, _ = _train(off_tr, 3)
    off_manager = CheckpointManager(tmp_path / "off", save_every=3)
    assert off_tr.save(off_manager, off)

    def leaves(m):
        d = m.directory / "step_000000003"
        return {f.name: f.read_bytes() for f in sorted(d.iterdir()) if f.name != "manifest.json"}

    assert leaves(manager) == leaves(off_manager) and len(leaves(manager)) > 1


def _reference_draws(method, key, shape, spec):
    """The SR draws the reference's ``fused_row_step`` takes from ``key``."""
    def sr(k):
        return torch.from_numpy(np.array(jq.sr_noise(k, shape)))

    if method == "lpt":
        return [sr(key)]
    if method == "alpt":
        return [sr(key), sr(jax.random.fold_in(key, 1))]
    if method == "qr_alpt":
        k_rem, k_quo = jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)
        return [sr(k) for k in (k_rem, k_quo, jax.random.fold_in(k_rem, 1),
                                jax.random.fold_in(k_quo, 1))]
    return [sr(jax.random.fold_in(key, g)) for g in range(methods.get(method).noise_draws(spec))]


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


def _unwrapped(state, slots, caches, unwrap):
    for slot, cache in zip(slots, caches):
        sub = slot.get(state)
        state = slot.put(state, sub._replace(codes=unwrap(cache, sub.codes)))
    return state


# qr_alpt below 8 bits re-quantizes at the table's width where the reference
# uses 8 bits (a recorded deviation, ROADMAP Queue C): at 8 bits only.
@pytest.mark.parametrize("method,bits", [(m, b) for b in (8, 4) for m in INT_METHODS
                                         if (m, b) != ("qr_alpt", 4)])
def test_cached_row_steps_equal_the_reference_bitwise(method, bits):
    """Rung 2 under a cache: 6 ``fused_row_step``s of the reference (its
    tiered container, its policy) and of the port (routed row steps), from
    the same state, given the reference's noise and a linear loss (the row
    gradient is the weight tensor exactly), the policies applied after each
    step: the exported states equal leaf for leaf, bit for bit, and so do
    the caches' counters."""
    kw = _spec_kw(method, bits=bits)
    jspec, pspec = jmethods.EmbeddingSpec(**kw), methods.EmbeddingSpec(**kw)
    jm, pm = jmethods.get(method), methods.get(method)
    js = jax.jit(lambda k: jm.init(k, jspec))(jax.random.PRNGKey(3))
    ps = interop.emb_state_from_numpy(pspec, _to_np(js), device="cpu")
    jslots, pslots = jm.storage_spec(jspec), pm.storage_spec(pspec)
    jcaches, pcaches = [], []
    for js_slot, ps_slot in zip(jslots, pslots):
        cap = min(3, ps_slot.rows)
        jc = JHotRowCache(cap, int(js_slot.get(js).codes.shape[0]), name=js_slot.name)
        pc = HotRowCache(cap, ps_slot.get(ps).codes.shape[0], name=ps_slot.name)
        js = js_slot.put(js, js_slot.get(js)._replace(codes=jc.wrap(js_slot.get(js).codes)))
        ps = ps_slot.put(ps, ps_slot.get(ps)._replace(codes=pc.wrap(ps_slot.get(ps).codes)))
        jcaches.append(jc)
        pcaches.append(pc)
    lr = f32(3e-3)
    jstep = jax.jit(lambda s, ids, w, k: jm.fused_row_step(
        s, ids, spec=jspec, loss_from_rows=lambda r, p: jnp.sum(r * p), dense_params=w,
        dense_opt=None, update_dense=lambda g, o, p: (p, o), lr=lr, weight_decay=5e-8,
        noise_key=k)[0])
    rs = np.random.RandomState(bits)
    for i in range(6):
        ids, _ = DATA.batch("train", i, 16)
        # The hot set moves each step (ids shifted), so rows are evicted.
        ids = ((ids + 11 * i) % pspec.n).astype(np.int32)
        wts = (rs.randn(*ids.shape, 8) * 0.3).astype(f32)
        key = jax.random.PRNGKey(20 + i)
        js = jstep(js, jnp.asarray(ids), jnp.asarray(wts), key)
        tw = torch.from_numpy(wts)
        ps, _ = pm.fused_row_step(
            ps, torch.from_numpy(ids), spec=pspec, loss_from_rows=lambda r: torch.sum(r * tw),
            dense_params=[], update_dense=lambda g: None, lr=float(lr), weight_decay=5e-8,
            noise=_reference_draws(method, key, (ids.size, pspec.d_padded), pspec))
        flat = ids.reshape(-1)
        for js_slot, ps_slot, jc, pc in zip(jslots, pslots, jcaches, pcaches):
            moves = jc.observe(js_slot.local_ids(flat), write=True)
            if moves is not None:
                sub = js_slot.get(js)
                js = js_slot.put(js, sub._replace(codes=jc.apply(sub.codes, moves)))
            pc.observe_apply(ps_slot.get(ps).codes, ps_slot.local_ids(flat), write=True)
    assert [c.stats() for c in jcaches] == [c.stats() for c in pcaches]
    assert sum(c.evictions for c in pcaches) > 0
    got = interop.emb_state_to_numpy(_unwrapped(ps, pslots, pcaches, lambda c, t: c.unwrap(t)))
    want = _to_np(_unwrapped(js, jslots, jcaches, lambda c, t: c.unwrap(t)))
    flat_got, flat_want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("alpt", 4), ("lpt", 8)])
def test_cached_trainer_tracks_the_reference_trainer(method, bits):
    """Rung 3: the port's cached trainer against the reference's
    (``cache_rows=8``) over 6 steps, given the reference's noise, exported
    states compared as tests/test_torch_train.py compares uncached ones (the
    DCN backward sums in another order: losses to rtol 1e-5, at most 0.1% of
    the codes a rounding apart); the caches' counters equal exactly."""
    kw = _spec_kw(method, bits=bits)
    if method == "lpt":
        kw["clip_value"] = 0.1
    jcfg = jtr.TrainerConfig(spec=jmethods.EmbeddingSpec(**kw), model="dcn",
                             dcn=jctr.DCNConfig(**DCN_KW), lr=3e-3, cache_rows=8)
    pcfg = TrainerConfig(spec=methods.EmbeddingSpec(**kw), dcn=DCNConfig(**DCN_KW), lr=3e-3,
                         cache_rows=8)
    jt, pt = jtr.CTRTrainer(jcfg), CTRTrainer(pcfg, device="cpu")
    js = jt.init_state()
    t = jt.export_state(js).emb_state
    ps = pt.import_state(interop.state_from_numpy(
        dataclasses.replace(pcfg, cache_rows=0), codes=np.array(t.codes.data),
        step=np.array(t.step), mu=np.array(t.mu), nu=np.array(t.nu), count=int(t.count),
        dense_params=jax.tree.map(np.array, js.dense_params), device="cpu"))
    d = pcfg.spec.d_padded
    jl, pl = [], []
    for i in range(6):
        ids, labels = DATA.batch("train", i, 32)
        kn = jax.random.split(js.rng, 3)[2]
        noise = _reference_draws(method, kn, (ids.size, d), pcfg.spec)
        js, jm = jt.train_step(js, ids, labels)
        ps, pm = pt.train_step(ps, ids, labels, noise=noise)
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pt.cache_stats() == jt.cache_stats()
    je, pe = jt.export_state(js).emb_state, pt.export_state(ps).emb_state
    codes_j = np.asarray(jax.device_get(je.codes.unpack()))
    assert (codes_j != pe.codes.unpack().numpy()).mean() <= 1e-3
    np.testing.assert_allclose(pe.step.numpy(), np.asarray(je.step), rtol=1e-5)
    assert pe.count == int(je.count) == 6


# ----------------------------------------------------------------- serving


def _score_all(engine, ids):
    rids = [engine.submit(CTRRequest(rid=i, ids=row)) for i, row in enumerate(ids)]
    done = engine.run()
    return [done[r]["prob"] for r in rids]


def _trained(method, steps=2, bits=8):
    tr = _trainer(method, cache_rows=0, bits=bits)
    state, _ = _train(tr, steps)
    return tr, state


@pytest.mark.parametrize("method", INT_METHODS)
def test_engine_cache_parity(method):
    """A hot-tier engine scores bitwise as the uncached one while the cache
    serves hits, through the routed plain gathers; the policy's counters
    equal the reference engine's on the same requests."""
    tr, state = _trained(method)
    ids, _ = DATA.batch("test", 0, 24)
    plain = CTREngine.from_state(state, tr.cfg, batch=4)
    cached = CTREngine.from_state(state, tr.cfg, batch=4, cache_rows=8)
    assert _score_all(plain, ids) == _score_all(cached, ids)
    m = cached.metrics()
    assert m.caches and m.cache_hit_rate > 0.0
    jspec = jmethods.EmbeddingSpec(**_spec_kw(method))
    jcfg = jtr.TrainerConfig(spec=jspec, model="dcn", dcn=jctr.DCNConfig(**DCN_KW))
    jt = jtr.CTRTrainer(jcfg)
    jengine = JEngine.from_state(jt.init_state(), jcfg, batch=4, cache_rows=8)
    for i, row in enumerate(ids):
        jengine.submit(JRequest(rid=i, ids=row))
    jengine.run()
    want = [(c.name, c.capacity, c.rows_cached, c.hits, c.misses, c.evictions)
            for c in jengine.metrics().caches]
    assert [(c.name, c.capacity, c.rows_cached, c.hits, c.misses, c.evictions)
            for c in m.caches] == want


def test_engine_restart_warm_start(tmp_path):
    """A serving checkpoint served through a hot tier warm-started from the
    training ids' counts: bitwise the live engine, hits from the first
    wave."""
    tr, state = _trained("alpt")
    freqs = np.zeros(tr.spec.n, np.int64)
    for i in range(2):
        np.add.at(freqs, DATA.batch("train", i, 16)[0].reshape(-1), 1)
    ckpt.save_serving_checkpoint(tmp_path, step=2, params=state.dense.param_tree(),
                                 table=state.emb_state, spec=tr.spec)
    live = CTREngine.from_state(state, tr.cfg, batch=4)
    restored = CTREngine.from_checkpoint(tmp_path, tr.cfg, batch=4, cache_rows=8, device="cpu")
    restored.warm_start(freqs)
    assert all(c.rows_cached == 8 and c.hits == 0 for c in restored.metrics().caches)
    ids, _ = DATA.batch("test", 1, 12)
    assert _score_all(live, ids) == _score_all(restored, ids)
    m = restored.metrics()
    assert m.cache_hit_rate > 0.0 and all(c.rows_cached > 0 for c in m.caches)
    with pytest.raises(ValueError, match="empty cache"):
        restored.warm_start(freqs)


@pytest.mark.parametrize("method", ["lpt", "alpt"])
def test_engine_cold_tier_parity_over_budget(method):
    """The cold tier serves a table whose codes exceed the device budget:
    codes in host memory, the device holding Delta + hot rows exactly,
    scores bitwise the uncached engine's, the next wave staged (prefetch
    hits on every wave but the first); an over-budget tier refused, and a
    composed table refused by the cold tier."""
    tr, state = _trained(method)
    plain = CTREngine.from_state(state, tr.cfg, batch=4)
    budget = plain.embedding_code_bytes - 1
    cold = CTREngine.from_state(state, tr.cfg, batch=4, cold_tier=True, cache_rows=8,
                                device_budget_bytes=budget)
    ids, _ = DATA.batch("test", 0, 24)
    assert _score_all(plain, ids) == _score_all(cold, ids)
    m = cold.metrics()
    width = plain.table.codes.data.shape[1]
    assert m.resident_embedding_bytes == 8 * width + tr.spec.n * 4 <= budget
    assert m.caches[0].tier == "cold" and m.cache_budget_bytes == budget
    assert m.prefetch_depth == 1 and m.int8_resident and cold.table is None
    assert cold.cold.prefetch_hits == 24 // 4 - 1 and cold.cold.demand_puts == 1
    assert cold.cold_host_bytes == plain.embedding_code_bytes
    assert m.kernel_launches == {}  # CPU tensors: the plain versions
    with pytest.raises(ValueError, match="budget"):
        CTREngine.from_state(state, tr.cfg, batch=4, cold_tier=True, cache_rows=8,
                             device_budget_bytes=16)
    with pytest.raises(ValueError, match="budget"):
        CTREngine.from_state(state, tr.cfg, batch=4, cache_rows=8, device_budget_bytes=16)
    qr_tr, qr_state = _trained("qr_lpt", steps=1)
    with pytest.raises(ValueError, match="plain QuantTable"):
        CTREngine.from_state(qr_state, qr_tr.cfg, batch=4, cold_tier=True, cache_rows=8)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_cold_tier_warm_start_and_demand_fetches(bits):
    """A cold tier (int8 and packed) warm-started from counts serves hits
    from the first wave; waves that were never staged are fetched on
    demand, bitwise."""
    tr, state = _trained("alpt", bits=bits)
    plain = CTREngine.from_state(state, tr.cfg, batch=4)
    cold = CTREngine.from_state(state, tr.cfg, batch=4, cold_tier=True, cache_rows=8)
    cold.warm_start(np.bincount(DATA.batch("train", 0, 16)[0].reshape(-1),
                                minlength=tr.spec.n))
    ids, _ = DATA.batch("test", 2, 8)
    want = _score_all(plain, ids)
    for i, row in enumerate(ids):  # one wave at a time: nothing is staged
        cold.submit(CTRRequest(rid=i, ids=row))
        cold.step()
    assert [cold.poll(i)["prob"] for i in range(len(ids))] == want
    assert cold.cold.demand_puts == len(ids) and cold.cold.prefetch_hits == 0
    assert cold.metrics().caches[0].hits > 0


@pytest.mark.parametrize("bits", [8, 4])
def test_cold_tier_stages_only_the_misses(bits):
    """Only the wave's distinct uncached rows are staged; an admitted row is
    copied into the hot tier from the staged rows; a row cached when the
    wave was staged and evicted by its own admissions is topped up; every
    read is bitwise the warm gather's."""
    from repro_torch.storage.cold import ColdStore

    g = torch.Generator().manual_seed(bits)
    n, d = 40, 13
    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (n, d), generator=g, dtype=torch.int8)
    step = torch.rand(n, generator=g) * 0.05 + 1e-3
    warm = CodeStore.from_codes(codes.clone(), bits)
    cold = ColdStore(warm, step, cache_rows=2)
    freqs = np.zeros(n, np.int64)
    freqs[[3, 5]] = 1
    cold.warm_start(freqs)  # 3 -> slot 0, 5 -> slot 1
    assert cold.copied_rows == 2
    # 9 and 7 are hotter than 5 and 3: 9 takes 5's slot, then 7 takes 3's
    # (every slot at the clock: slot 0), so 3 is evicted by its own wave.
    wave = np.array([3, 7, 7, 7, 9, 9, 9, 9, 9, 11], np.int64)
    cold.stage(wave)
    assert cold.copied_rows == 2 + 3  # 7, 9 and 11; 3 is cached
    cold.admit(wave)
    assert cold.cache.slot_of_arr[[3, 5, 7, 9]].tolist() == [-1, -1, 0, 1]
    assert cold.copied_rows == 2 + 3  # the admissions came from the staged rows
    got = cold.rows(wave)
    want = ops.dequant_gather(warm, step, torch.from_numpy(wave.astype(np.int32)))
    assert torch.equal(got, want)
    assert cold.topup_rows == 1 and cold.prefetch_hits == 1 and cold.demand_puts == 0
    assert torch.equal(cold.hot, warm.data[[7, 9]])
    # Unstaged: a demand fetch of the misses left after admission.
    wave2 = np.array([7, 9, 20, 21, 21], np.int64)
    got = cold.rows(wave2)
    assert torch.equal(got, ops.dequant_gather(warm, step, torch.from_numpy(wave2.astype(np.int32))))
    assert cold.demand_puts == 1 and cold.copied_rows == 2 + 3 + 1 + 2


def test_resident_bytes_include_cache_metadata():
    """A hot tier grows the resident bytes by its rows and its id maps."""
    tr, state = _trained("alpt", steps=1)
    plain = CTREngine.from_state(state, tr.cfg, batch=4)
    cached = CTREngine.from_state(state, tr.cfg, batch=4, cache_rows=8)
    pm, cm = plain.metrics(), cached.metrics()
    hot = cm.caches[0]
    maps = (tr.spec.n + 8) * 4
    assert hot.hot_bytes == 8 * 8 and hot.metadata_bytes > maps
    assert cm.resident_embedding_bytes == pm.resident_embedding_bytes + hot.hot_bytes + maps
    slot = methods.get(tr.spec.method).storage_spec(tr.spec)[0]
    codes = slot.get(cached.table).codes
    assert isinstance(codes, TieredCodes)
    assert codes.resident_bytes == (codes.backing.resident_bytes + codes.hot_bytes
                                    + codes.metadata_bytes)


def test_engine_metrics_schema():
    """``to_json`` keeps the port's keys, adds the reference's cache keys
    only with a tier, and each cache entry has the reference's
    ``CacheMetrics`` fields."""
    tr, state = _trained("lpt", steps=1)
    engine = CTREngine.from_state(state, tr.cfg, batch=4, cache_rows=8)
    _score_all(engine, DATA.batch("test", 0, 8)[0])
    m = engine.metrics()
    assert isinstance(m, EngineMetrics)
    j = m.to_json()
    for key in ["scenario", "embedding_method", "requests_submitted", "requests_completed",
                "steps", "wall_s", "resident_embedding_bytes", "embedding_code_bytes",
                "embedding_scale_bytes", "int8_resident", "kernel_launches", "us_per_request",
                "caches", "cache_hit_rate", "cache_budget_bytes", "prefetch_depth"]:
        assert key in j, key
    assert set(j["caches"][0]) == {f.name for f in dataclasses.fields(JCacheMetrics)}
    assert {f.name for f in dataclasses.fields(CacheMetrics)} == {
        f.name for f in dataclasses.fields(JCacheMetrics)}
    assert json.loads(json.dumps(j)) == j
    plain = CTREngine.from_state(state, tr.cfg, batch=4)
    pj = plain.metrics().to_json()
    assert not {"caches", "cache_hit_rate", "cache_budget_bytes", "prefetch_depth"} & set(pj)


# -------------------------------------------------------- plain versions


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_routed_plain_versions_equal_the_untiered_over_the_logical_table(bits):
    """The routed gathers (map and staged) and the routed runs form, plain,
    against the untiered plain versions over the logical table (a
    consistent hot tier): equal outputs, and the same logical table and
    slots after the row step."""
    from repro_torch.core import lpt

    g = torch.Generator().manual_seed(bits)
    n, d = 300, 13
    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (n, d), generator=g, dtype=torch.int8)
    step = torch.rand(n, generator=g) * 0.05 + 1e-3
    ids = (torch.rand(900, generator=g) ** 3 * (n - 1)).to(torch.int32)
    cache = HotRowCache(40, n)
    tiered = cache.observe_apply(cache.wrap(CodeStore.from_codes(codes.clone(), bits)),
                                 torch.unique(ids)[::2].numpy())
    flat = CodeStore.from_codes(codes.clone(), bits)
    want = ops.dequant_gather(flat, step, ids)
    assert torch.equal(ops.dequant_gather(tiered, step, ids), want)
    slot = tiered.slot_of_id[ids.long()]
    # Staged as the cold tier stages: the distinct uncached rows, each
    # lookup a hot slot or -1 - its staged row.
    miss = slot < 0
    need, inv = torch.unique(ids[miss], return_inverse=True)
    enc = slot.clone()
    enc[miss] = (-1 - inv).to(torch.int32)
    staged = ops.dequant_gather_staged(tiered.backing.data[need.long()], tiered.hot.data, enc,
                                       step, ids, bits=bits, d=d, packed=tiered.packed)
    assert torch.equal(staged, want)
    uniq, _, order, starts = lpt.dedup_runs(ids, n - 1)  # the last row as the scratch row
    g_occ = torch.randn(900, d, generator=g) * 0.1
    noise = torch.rand(900, d, generator=g)
    mu, nu = torch.randn(n, d, generator=g) * 1e-3, torch.rand(n, d, generator=g) * 1e-4
    outs = []
    for store in (tiered, flat):
        m, v = mu.clone(), nu.clone()
        w = ops.sparse_row_update_runs(store, step, m, v, uniq, g_occ, order, starts, noise,
                                       0.01, 0.1, 0.001, bits, weight_decay=5e-8)
        outs.append((store.unpack()[: n - 1], m, v, w[uniq < n - 1]))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert torch.equal(ref.routed_rows(tiered.backing.data, tiered.hot.data, slot, ids),
                       flat.data[ids.long()])


def test_dispatch_refuses_a_tiered_table_without_a_routed_kernel():
    tiered = HotRowCache(2, 8).wrap(CodeStore.from_codes(torch.zeros(8, 4, dtype=torch.int8), 8))
    step = torch.ones(8)
    with pytest.raises(TypeError, match="TieredCodes"):
        ops.lpt_update(tiered, step, torch.zeros(8, 4), torch.rand(8, 4), 0.01, 8)
    with pytest.raises(TypeError, match="TieredCodes"):
        ops.dequant_matmul(torch.zeros(2, 4), tiered, step)
    with pytest.raises(TypeError, match="TieredCodes"):
        ops.sparse_row_update(tiered, step, torch.zeros(8, 4), torch.zeros(8, 4),
                              torch.arange(2, dtype=torch.int32), torch.zeros(2, 4),
                              torch.rand(2, 4), 0.01, 0.1, 0.001, 8)


# -------------------------------------------------------------------- CLIs


def test_train_cli_zipf_with_a_cache_equals_the_uncached_run(capsys):
    """``train ctr --zipf --cache-rows``: per-slot stats printed and in the
    JSON line, losses equal to the uncached run's."""
    argv = ["ctr", "--zipf", "--steps", "4", "--batch", "64", "--method", "alpt", "--device",
            "cpu"]
    assert train_cli.main(argv) == 0
    off = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert train_cli.main(argv + ["--cache-rows", "400"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    on = json.loads(lines[-1])
    assert on["losses"] == off["losses"] and "caches" not in off
    assert on["caches"][0]["name"] == "table" and on["caches"][0]["hits"] > 0
    assert any(line.startswith("[train] hot tier 'table'") for line in lines)
    assert "zipf fixture" in lines[-3]


@pytest.mark.parametrize("cold", [False, True])
def test_serve_cli_zipf_tiers(capsys, cold):
    argv = ["ctr", "--zipf", "--requests", "48", "--batch", "16", "--device", "cpu",
            "--method", "lpt" if cold else "qr_alpt", "--cache-rows", "409"]
    assert serve_cli.main(argv + (["--cold-tier"] if cold else [])) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    m = json.loads(lines[-1])
    tier = "cold" if cold else "hot"
    assert [c["tier"] for c in m["caches"]] == [tier] * (1 if cold else 2)
    assert any(line.startswith(f"[serve] {tier} tier") for line in lines)
    assert any(line.startswith("[serve] aggregate cache hit rate") for line in lines)
    assert m["cache_hit_rate"] > 0
