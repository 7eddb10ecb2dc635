"""Port parity for the rest of the paper's embedding methods, module by module.

Rungs (ROADMAP's parity ladder): ``fake_quant_pact``'s forward and weight
gradient, the prune threshold and mask, ``prune_ratio``, ``qr_rows``, the
theorem bounds and the composed serving tables' rows are bitwise (rung 1);
the state after one row step of qr_lpt, qr_alpt and mixed, given the
reference's state, ids, row gradients and SR noise, is bitwise on every
live row (rung 2).  PACT's alpha gradient sums over the row in another
order than XLA's (rtol 1e-6); the Fig. 3 problem's trajectories are held
at rtol 1e-6 (XLA contracts ``w - eta_t * g`` into an fma).  The reference
runs jitted, with its kernels off (its own kernels-on == kernels-off
contract); the port's kernels-on path takes the plain versions on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import methods as jmethods
from repro.models import embedding as jemb
from repro.core import hashing as jhash
from repro.core import pruning as jprune
from repro.core import quant as jq
from repro.core import theory as jtheory
from repro.data.ctr_synth import avazu_like
from repro_torch import interop
from repro_torch import methods as pmethods
from repro_torch.core import hashing as phash
from repro_torch.core import pruning as pprune
from repro_torch.core import quant as pq
from repro_torch.core import theory as ptheory
from repro_torch.methods.mixed import assign_field_bits, plan_of
from repro_torch.models import embedding as pemb
from repro_torch.serving import table as serving_tbl

f32 = np.float32


def to_np(x):
    """A reference state as interop's numpy layout: ``_asdict`` at every
    level, a ``CodeStore`` as its bytes, tuples as lists."""
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if hasattr(x, "data") and hasattr(x, "packed"):
        return np.array(x.data)
    if isinstance(x, (tuple, list)):
        return [to_np(v) for v in x]
    if isinstance(x, (int, float)):
        return x
    return np.array(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jinit(method, seed, spec):
    """The reference's initial state, its init jitted once."""
    return jax.jit(lambda k: jmethods.get(method).init(k, spec))(jax.random.PRNGKey(seed))


# ----------------------------------------------------------------- PACT


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_row", [True, False])
def test_fake_quant_pact_forward_backward(bits, per_row):
    rs = np.random.RandomState(bits)
    w = (rs.randn(40, 16) * 0.05).astype(f32)
    alpha = (rs.uniform(0.02, 0.08, 40) if per_row else np.array(0.05)).astype(f32)
    g = rs.randn(40, 16).astype(f32)

    @jax.jit
    def ref(w, a, g):
        y, pull = jax.vjp(lambda w, a: jq.fake_quant_pact(w, a, bits), w, a)
        return y, *pull(g)

    jy, jdw, jda = (np.asarray(x) for x in ref(w, alpha, g))
    tw, ta = _t(w).requires_grad_(True), _t(alpha).requires_grad_(True)
    y = pq.fake_quant_pact(tw, ta, bits)
    dw, da = torch.autograd.grad(y, [tw, ta], _t(g))
    np.testing.assert_array_equal(y.detach().numpy(), jy)
    np.testing.assert_array_equal(dw.numpy(), jdw)
    assert da.shape == jda.shape
    np.testing.assert_allclose(da.numpy(), jda, rtol=1e-6, atol=1e-6)
    assert (np.abs(w) >= alpha[..., None] if per_row else np.abs(w) >= alpha).any()


# ----------------------------------------------------------------- pruning


def test_prune_ratio_bitwise_over_the_schedule():
    cfg = jprune.PruneConfig()
    pcfg = pprune.PruneConfig()
    ref = jax.jit(lambda s: jprune.prune_ratio(cfg, s))
    for step in list(range(0, 400, 3)) + list(range(400, 40_000, 97)):
        assert pprune.prune_ratio(pcfg, step) == float(ref(jnp.int32(step))), step


@pytest.mark.parametrize("n", [2, 7, 1000, 4097])
def test_quantile_linear_bitwise_vs_jnp(n):
    rs = np.random.RandomState(n)
    a = np.abs(rs.randn(n) * 0.01).astype(f32)
    ref = jax.jit(jnp.quantile)
    for q in [0.0, 1.0, 0.5, *rs.rand(20).astype(f32)]:
        want = np.asarray(ref(a, f32(q)))
        got = pprune.quantile_linear(_t(a), float(f32(q))).numpy()
        assert got == want, (n, q, got, want)


def test_quantile_linear_past_torch_quantile_limit():
    """2^24 + 5 elements, past the 2^24 that ``torch.quantile`` takes: the
    neighbours numpy's partition gives, interpolated as ``jnp.quantile``
    does (the float32 position, ``fma(hi, w_hi, lo * w_lo)``), and between
    them."""
    n = 2**24 + 5
    a = np.random.RandomState(0).rand(n).astype(f32)
    got = pprune.quantile_linear(_t(a), 0.3).numpy()
    pos = f32(0.3) * (f32(n) - f32(1))
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = f32(pos - np.floor(pos))
    srt = np.partition(a, (lo, hi))
    # fma in float64: the product is exact, the one rounding is the cast
    # (no tie can arise at these magnitudes).
    want = f32(np.float64(srt[hi]) * np.float64(w_hi) + np.float64(srt[lo] * (f32(1) - w_hi)))
    assert got == want and srt[lo] <= got <= srt[hi]


@pytest.mark.parametrize("step", [0, 5, 40, 400])
def test_update_mask_bitwise(step):
    cfg = jprune.PruneConfig(target_sparsity=0.5, warmup_steps=3, damping=0.5, damping_steps=7)
    st = jprune.init_prune(jax.random.PRNGKey(step), 97, 13, init_scale=0.05)._replace(
        step=jnp.int32(step))
    want = jax.jit(lambda s: jprune.update_mask(s, cfg))(st)
    got = pprune.update_mask(pprune.PruneState(weights=_t(st.weights),
                                               mask=_t(st.mask), step=step),
                             pprune.PruneConfig(*cfg))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert float(pprune.sparsity(got)) == float(jprune.sparsity(want))
    if step >= 5:  # pruned at the scheduled ratio (ties at the threshold go too)
        ratio = pprune.prune_ratio(pprune.PruneConfig(*cfg), step)
        assert 0.0 < ratio and abs(float(pprune.sparsity(got)) - ratio) <= 2 / (97 * 13)


# ----------------------------------------------------------------- hashing, theory


def test_qr_rows_and_lookup():
    for n, c in [(10, 2.0), (103, 2.0), (1000, 4.0), (1_086_878, 2.0),
                 (avazu_like(1.0).n_features, 2.0)]:
        assert phash.qr_rows(n, c) == jhash.qr_rows(n, c), n
    assert phash.qr_rows(4_428_281) == (2, 2_214_141)
    jt = jhash.init_qr(jax.random.PRNGKey(0), 103, 8)
    pt = phash.QRTable(remainder=_t(jt.remainder), quotient=_t(jt.quotient), r=jt.r)
    ids = np.arange(103, dtype=np.int32)[::-1].copy()
    np.testing.assert_array_equal(phash.qr_lookup(pt, _t(ids)).numpy(),
                                  np.asarray(jhash.qr_lookup(jt, jnp.asarray(ids))))
    assert phash.qr_memory_bytes(pt) == jhash.qr_memory_bytes(jt)


def test_theorem_bounds_equal():
    for args in [(1.0, 2.0, 0.3, 16, 0.01, 1000), (0.5, 1.0, 1.0, 1000, 0.01, 50),
                 (2.0, 3.0, 0.05, 4, 0.1, 10_000)]:
        assert ptheory.sr_bound(*args) == jtheory.sr_bound(*args)
        assert ptheory.dr_bound(*args) == jtheory.dr_bound(*args)


@pytest.mark.parametrize("method", ["fp", "dr", "sr"])
def test_synthetic_experiment_with_reference_draws(method):
    """Fig. 3's problem at n = 300, 200 iterations, fed the reference's
    initial weights and per-iteration SR noise (its key chain)."""
    n, iters = 300, 200
    ref = jtheory.synthetic_experiment(method, iters=iters, n=n, seed=3)
    k0, k = jax.random.split(jax.random.PRNGKey(3))
    w0 = np.asarray(jax.random.uniform(k0, (n,), jnp.float32))
    draws = []
    for _ in range(iters):
        k, kn = jax.random.split(k)
        draws.append(np.asarray(jq.sr_noise(kn, (n,))))
    got = ptheory.synthetic_experiment(method, iters=iters, n=n, w0=_t(w0),
                                       noise=_t(np.stack(draws)), device="cpu")
    for name in ("w_final", "mean_abs_err", "stalled_frac"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    if method == "dr":  # Remark 1: DR stalls
        assert float(got.stalled_frac[-1]) == 1.0
    if method == "sr":
        assert float(got.mean_abs_err[-1]) < 0.01


def test_synthetic_experiment_runs_on_the_requested_device():
    """The entry point runs on the card by default: here, with no card, the
    default raises, and ``device="cpu"`` draws w0 and the SR noise from a
    CPU generator seeded 0."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ptheory.synthetic_experiment("sr", iters=2, n=4)
    got = ptheory.synthetic_experiment("sr", iters=3, n=16, device="cpu")
    g = torch.Generator().manual_seed(0)
    w0 = torch.rand((16,), generator=g)
    noise = torch.rand((3, 16), generator=g)
    want = ptheory.synthetic_experiment("sr", iters=3, n=16, w0=w0, noise=noise, device="cpu")
    assert got.w_final.device.type == "cpu"
    assert torch.equal(got.w_final, want.w_final)
    assert torch.equal(got.mean_abs_err, want.mean_abs_err)


# ----------------------------------------------------------------- composed row steps

CARDS = (5, 3, 40, 300, 9, 700)
FIELD_BITS = (8, 8, 8, 4, 8, 2)  # mixed: three groups, as at the full Avazu table


def _spec_pair(method, pad, bits=8, d=8):
    mixed = method == "mixed"
    kw = dict(method=method, n=sum(CARDS), d=d, bits=bits, init_scale=0.05, pad_to_tiles=pad,
              field_cards=CARDS if mixed else None, field_bits=FIELD_BITS if mixed else None)
    return jmethods.EmbeddingSpec(**kw, use_kernels=False), pmethods.EmbeddingSpec(**kw)


def _wave(seed, batch=48):
    rs = np.random.RandomState(seed)
    offs = np.cumsum((0,) + CARDS[:-1])
    local = np.stack([np.minimum(rs.zipf(1.3, batch), c) - 1 for c in CARDS], 1)
    return (local + offs).astype(np.int32), rs


def _assert_lpt_equal(pt, jt, live, ctx):
    got, want = interop.emb_state_to_numpy(pt), to_np(jt)
    for k in ("codes", "step", "mu", "nu"):
        np.testing.assert_array_equal(got[k][:live], want[k][:live], err_msg=f"{ctx}: {k}")
    assert got["count"] == int(want["count"])


@pytest.mark.parametrize("method,pad", [("qr_lpt", False), ("mixed", False), ("mixed", True)])
def test_sparse_apply_two_steps_bitwise(method, pad):
    jspec, pspec = _spec_pair(method, pad)
    jm, pm = jmethods.get(method), pmethods.get(method)
    js = _jinit(method, 1, jspec)
    ps = interop.emb_state_from_numpy(pspec, to_np(js), device="cpu")
    step = jax.jit(lambda s, ids, g, k: jm.sparse_apply(
        s, ids, g, spec=jspec, lr=f32(3e-3), weight_decay=5e-8, noise_key=k))
    for i in range(2):
        ids, rs = _wave(i)
        g = (rs.randn(*ids.shape, 8) * 0.05).astype(f32)
        key = jax.random.PRNGKey(10 + i)
        noise = [_t(jq.sr_noise(jax.random.fold_in(key, j), (ids.size, pspec.d_padded)))
                 for j in range(pm.noise_draws(pspec))]
        js = step(js, jnp.asarray(ids), jnp.asarray(g), key)
        ps = pm.sparse_apply(ps, _t(ids), _t(g), spec=pspec, lr=float(f32(3e-3)),
                             weight_decay=5e-8, noise=noise)
    if method == "mixed":
        plan = plan_of(pspec)
        assert plan.group_bits == (8, 4, 2) and len(ps.subs) == 3
        for g, (a, b) in enumerate(zip(ps.subs, js.subs)):
            _assert_lpt_equal(a, b, plan.group_rows[g], f"group {g}")
    else:
        r, q = phash.qr_rows(pspec.n)
        _assert_lpt_equal(ps.remainder, js.remainder, r, "remainder")
        _assert_lpt_equal(ps.quotient, js.quotient, q, "quotient")
    ids = np.arange(pspec.n, dtype=np.int32)
    np.testing.assert_array_equal(pm.lookup(ps, _t(ids), pspec).numpy(),
                                  np.asarray(jm.lookup(js, jnp.asarray(ids), jspec)))


def _qr_alpt_steps(bits, ref_alpt_bits=None):
    """qr_alpt's whole fused step on both sides through a linear loss (its
    row gradient is the weight tensor exactly on both sides), the
    reference's ALPTConfig.bits set to ``ref_alpt_bits`` where given.
    Returns (port state, reference state, port aux, reference aux, spec)."""
    jspec, pspec = _spec_pair("qr_alpt", True, bits=bits)
    jalpt = jspec.alpt._replace(step_lr=2e-3)
    if ref_alpt_bits is not None:
        jalpt = jalpt._replace(bits=ref_alpt_bits)
    jspec = dataclasses.replace(jspec, alpt=jalpt)
    pspec = dataclasses.replace(pspec, alpt=pspec.alpt._replace(step_lr=2e-3))
    jm, pm = jmethods.get("qr_alpt"), pmethods.get("qr_alpt")
    ids, rs = _wave(7)
    wts = (rs.randn(*ids.shape, 8) * 0.3).astype(f32)
    key = jax.random.PRNGKey(9)

    def jloss(rows, p):
        return jnp.sum(rows * p)

    @jax.jit
    def init_and_step(k):  # one compile for the initial state and the step
        s = jm.init(k, jspec)
        return s, jm.fused_row_step(
            s, jnp.asarray(ids), spec=jspec, loss_from_rows=jloss,
            dense_params=jnp.asarray(wts), dense_opt=None, update_dense=lambda g, o, p: (p, o),
            lr=f32(3e-3), weight_decay=5e-8, noise_key=key)

    js, (js2, _, _, jaux) = init_and_step(jax.random.PRNGKey(4))
    ps = interop.emb_state_from_numpy(pspec, to_np(js), device="cpu")
    k_rem, k_quo = jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)
    shape = (ids.size, pspec.d_padded)
    noise = [_t(jq.sr_noise(k, shape)) for k in (k_rem, k_quo, jax.random.fold_in(k_rem, 1),
                                                 jax.random.fold_in(k_quo, 1))]
    tw = _t(wts)
    ps2, aux = pm.fused_row_step(
        ps, _t(ids), spec=pspec, loss_from_rows=lambda rows: torch.sum(rows * tw),
        dense_params=[], update_dense=lambda g: None, lr=float(f32(3e-3)), weight_decay=5e-8,
        noise=noise)
    assert not np.array_equal(ps2.quotient.step.numpy(), np.asarray(js.quotient.step))
    return ps2, js2, aux, jaux, pspec


def test_qr_alpt_row_step_bitwise():
    """The weight sub-step, the joint Delta gradient through the
    fake-quantized product, line 5: bitwise on the live rows."""
    ps2, js2, aux, jaux, pspec = _qr_alpt_steps(8)
    r, q = phash.qr_rows(pspec.n)
    _assert_lpt_equal(ps2.remainder, js2.remainder, r, "remainder")
    _assert_lpt_equal(ps2.quotient, js2.quotient, q, "quotient")
    np.testing.assert_allclose(float(aux["mean_step"]), float(jaux["mean_step"]), rtol=1e-6)


def test_qr_alpt_row_step_at_4_bits_takes_the_table_width():
    """At 4 bits the port's Delta sub-step takes the table's width, as alpt
    does: bitwise the reference's kernels-off step with its ALPTConfig.bits
    set to 4.  The reference's qr_alpt keeps ALPTConfig.bits (8), so its
    LSQ clip and line-5 re-quantize run at 8 bits into the 4-bit packed
    containers and give another state (ROADMAP, Queue C)."""
    ps2, js2, _, _, pspec = _qr_alpt_steps(4, ref_alpt_bits=4)
    r, q = phash.qr_rows(pspec.n)
    _assert_lpt_equal(ps2.remainder, js2.remainder, r, "remainder")
    _assert_lpt_equal(ps2.quotient, js2.quotient, q, "quotient")
    _, jdefault, _, _, _ = _qr_alpt_steps(4)
    got, other = interop.emb_state_to_numpy(ps2), to_np(jdefault)
    assert any(not np.array_equal(got[part][k], other[part][k])
               for part in ("remainder", "quotient") for k in ("codes", "step"))


def test_mixed_plan_of_the_full_avazu_table():
    """assign_field_bits over the Avazu cardinalities: three groups, the
    rows 82, 13,867 and 4,414,332, and the resident bytes at d = 16."""
    cards = tuple(avazu_like(1.0).cardinalities)
    assert assign_field_bits(cards) == jmethods.mixed.assign_field_bits(cards)
    spec = pmethods.EmbeddingSpec(method="mixed", n=sum(cards), d=16, field_cards=cards)
    plan = plan_of(spec)
    jplan = jmethods.mixed.plan_of(jmethods.EmbeddingSpec(method="mixed", n=sum(cards), d=16,
                                                          field_cards=cards))
    assert dataclasses.astuple(plan) == dataclasses.astuple(jplan)
    assert plan.group_bits == (8, 4, 2)
    assert plan.group_rows == (82, 13_867, 4_414_332)
    assert [len(f) for f in plan.group_fields][0] == 3
    code_bytes = sum(r * -(-16 * b // 8) for r, b in zip(plan.group_rows, plan.group_bits))
    assert code_bytes == 17_769_576 and code_bytes + 4 * sum(plan.group_rows) == 35_482_700


# ----------------------------------------------------------------- serving tables


@pytest.mark.parametrize("method,pad", [("qr_alpt", False), ("qr_lpt", True), ("mixed", True)])
def test_composed_serving_rows_bitwise(method, pad):
    jspec, pspec = _spec_pair(method, pad, d=12)
    jm, pm = jmethods.get(method), pmethods.get(method)
    js = _jinit(method, 2, jspec)
    ps = interop.emb_state_from_numpy(pspec, to_np(js), device="cpu")
    jt, pt = jm.serving_state(js, jspec), pm.serving_state(ps, pspec)
    ids, _ = _wave(3)
    want = np.asarray(jax.jit(jt.rows)(jnp.asarray(ids)))
    np.testing.assert_array_equal(pt.rows(_t(ids)).numpy(), want)
    np.testing.assert_array_equal(pm.lookup(ps, _t(ids), pspec).numpy(), want)
    assert pt.code_bytes() == jt.code_bytes() and pt.scale_bytes() == jt.scale_bytes()
    assert pt.live_rows() == jt.live_rows() == pspec.n
    assert pt.code_bytes() + pt.scale_bytes() == \
        serving_tbl.resident_bytes(pt) == pm.memory_bytes(ps, pspec, training=False)
    assert serving_tbl.is_integer_resident(pt)


# ----------------------------------------------------------------- the embedding shim


@pytest.mark.parametrize("method", pmethods.available())
def test_embedding_shim_matches_the_reference(method):
    """``models.embedding``'s function-style API against the reference's, on
    the reference's initial state: the lookup bitwise (rung 1), the
    accounting, the capability of trainable leaves and their round trip."""
    jspec, pspec = _spec_pair(method, False)
    ids, _ = _wave(11)

    @jax.jit
    def init_and_lookup(key, i):
        state = jemb.init_embedding(key, jspec)
        return state, jemb.lookup(state, i, jspec)

    js, want = init_and_lookup(jax.random.PRNGKey(5), jnp.asarray(ids))
    ps = interop.emb_state_from_numpy(pspec, to_np(js), device="cpu")
    want = np.asarray(want)
    np.testing.assert_array_equal(pemb.lookup(ps, _t(ids), pspec).numpy(), want)
    assert pemb.memory_bytes(ps, pspec, training=True) == \
        jemb.memory_bytes(js, jspec, training=True)
    if method != "prune":  # the reference scales by a float32 mean of the mask
        assert pemb.memory_bytes(ps, pspec, training=False) == \
            jemb.memory_bytes(js, jspec, training=False)
    params = pemb.trainable_params(ps, pspec)
    assert (params is None) == (jemb.trainable_params(js, jspec) is None)
    np.testing.assert_array_equal(pemb.lookup(pemb.with_params(ps, params, pspec), _t(ids),
                                              pspec).numpy(), want)
