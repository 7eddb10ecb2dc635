"""Port parity for the training slice's numerics (rung 1): the row-step kernel's
plain version, its scalars, dedup + segment sum, fake-quant LSQ and Adam.

The reference's numbers are the ones XLA:CPU computes when the reference runs
as it trains, i.e. jitted: ``repro.kernels.ops.sparse_row_update`` (the
interpreted Pallas kernel, or its jitted jnp oracle off the 8-multiple
shapes) and ``jax.jit(adam_update)``.  XLA:CPU contracts multiply-adds there
into fused multiply-adds, so the port's plain versions round once where it
does (``repro_torch.kernels.ref.fma``); the reference run eagerly rounds
twice and is not the oracle here.
"""
import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codestore as jcs
from repro.core import lpt as jlpt
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.optim import adam_init as j_adam_init
from repro.optim import adam_update as j_adam_update
from repro.optim import schedule as jsched
from repro.training import ctr_trainer as jtr
from repro_torch.core import lpt as plpt
from repro_torch.core import quant as pq
from repro_torch.core.codestore import CodeStore
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.optim import OptState, adam_update
from repro_torch.optim import schedule as psched
from repro_torch.training import ctr_trainer as ptr

f32 = np.float32


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps (same-sign finite values)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _row_step_operands(seed, bits, d, n_live=56, batch=30):
    """A scratch-row table (n_live + 8 rows) and one batch's dedup: many
    repeated ids and sentinel padding, as the training path builds them."""
    rs = np.random.RandomState(seed)
    n = n_live + 8
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = rs.randint(lo, hi + 1, (n, d)).astype(np.int8)
    step = rs.uniform(1e-3, 0.05, n).astype(f32)
    mu = (rs.randn(n, d) * 0.01).astype(f32)
    nu = (rs.rand(n, d) * 1e-3).astype(f32)
    ids = np.minimum(rs.zipf(1.3, batch), n_live - 1).astype(np.int32) - 1
    ids[:3] = [0, n_live - 1, 0]
    uniq, inv = jlpt.dedup_ids(jnp.asarray(ids), n_live)
    k = len(ids)
    g_occ = (rs.randn(k, d) * 0.1).astype(f32)
    g_sum = np.array(jnp.zeros((k, d), jnp.float32).at[inv].add(g_occ))
    noise = rs.rand(k, d).astype(f32)
    c1, c2 = plpt.adam_bias_corrections(7)
    return codes, step, mu, nu, np.array(uniq), g_sum, noise, c1, c2, n_live


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [16, 15])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_sparse_row_update_plain_matches_reference(bits, d, weight_decay, use_kernel):
    codes, step, mu, nu, uniq, g_sum, noise, c1, c2, n_live = _row_step_operands(
        bits * 31 + d, bits, d)
    lr = f32(0.01)
    jstore = jcs.CodeStore.from_codes(jnp.asarray(codes), bits)
    with jops.fallback_scope() as scope:
        ref = jops.sparse_row_update(jstore, step, mu, nu, uniq, g_sum, noise, lr, c1, c2, bits,
                                     weight_decay=weight_decay, use_kernel=use_kernel)
    if use_kernel:  # the interpreted Pallas kernel at 8-multiple widths, else its oracle
        assert scope.stats()["kernel_calls"].get("sparse_row_update", 0) == int(d % 8 == 0)
    store = CodeStore.from_codes(torch.from_numpy(codes.copy()), bits)
    assert store.packed == (bits < 8)
    pmu, pnu = torch.from_numpy(mu.copy()), torch.from_numpy(nu.copy())
    w_new = pops.sparse_row_update(store, torch.from_numpy(step), pmu, pnu,
                                   torch.from_numpy(uniq), torch.from_numpy(g_sum),
                                   torch.from_numpy(noise), float(lr), c1, c2, bits,
                                   weight_decay=weight_decay)
    live = slice(0, n_live)  # the scratch row's bytes are unspecified
    np.testing.assert_array_equal(store.data.numpy()[live], np.asarray(ref[0].data)[live])
    np.testing.assert_array_equal(pmu.numpy()[live], np.asarray(ref[1])[live])
    np.testing.assert_array_equal(pnu.numpy()[live], np.asarray(ref[2])[live])
    real = uniq < n_live
    got, want = w_new.numpy()[real], np.asarray(ref[3])[real]
    if (bits, d) == (4, 15):
        # XLA fuses the packed d=15 oracle's unpack + slice with the update and
        # contracts one more product there, so a few of its w_new rows (an aux
        # output; the codes above, computed from them, agree) are 1 ulp apart.
        assert _ulps(got, want).max() <= 1 and (got != want).mean() <= 0.03
    else:
        np.testing.assert_array_equal(got, want)


def test_sparse_row_update_plain_leaves_other_rows_alone():
    codes, step, mu, nu, uniq, g_sum, noise, c1, c2, n_live = _row_step_operands(3, 8, 16)
    t_codes, t_mu, t_nu = (torch.from_numpy(x.copy()) for x in (codes, mu, nu))
    pops.sparse_row_update(t_codes, torch.from_numpy(step), t_mu, t_nu, torch.from_numpy(uniq),
                           torch.from_numpy(g_sum), torch.from_numpy(noise), 0.01, c1, c2, 8)
    untouched = np.setdiff1d(np.arange(len(codes)), uniq)
    assert len(untouched) > 10
    for got, before in ((t_codes, codes), (t_mu, mu), (t_nu, nu)):
        np.testing.assert_array_equal(got.numpy()[untouched], before[untouched])
    touched = np.unique(uniq[uniq < n_live])
    assert (t_mu.numpy()[touched] != mu[touched]).all()


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_sparse_row_update_plain_drops_a_sentinel_past_the_table(bits):
    """With no scratch row the sentinel lies past the table: its slots step
    the clamped last row (finite ``w_new``) and write nothing, so live rows
    and real slots equal the scratch-row table's, which the reference
    checks."""
    codes, step, mu, nu, uniq, g_sum, noise, c1, c2, n_live = _row_step_operands(
        bits + 40, bits, 16)
    assert (uniq == n_live).any() and (uniq == n_live - 1).any()
    out = []
    for rows in (n_live + 8, n_live):
        store = CodeStore.from_codes(torch.from_numpy(codes[:rows].copy()), bits)
        pmu, pnu = torch.from_numpy(mu[:rows].copy()), torch.from_numpy(nu[:rows].copy())
        w_new = pops.sparse_row_update(store, torch.from_numpy(step[:rows]), pmu, pnu,
                                       torch.from_numpy(uniq), torch.from_numpy(g_sum),
                                       torch.from_numpy(noise), 0.01, c1, c2, bits,
                                       weight_decay=5e-8)
        out.append((store.data.numpy()[:n_live], pmu.numpy()[:n_live], pnu.numpy()[:n_live],
                    w_new.numpy()))
    real = uniq < n_live
    for a, b in zip(out[0][:3], out[1][:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[0][3][real], out[1][3][real])
    assert np.isfinite(out[1][3]).all()


def test_fma_rounds_once():
    rs = np.random.RandomState(0)
    a, b, c = (rs.randn(4000).astype(f32) * s for s in (1.0, 1e-3, 1e-6))
    a[:3], b[:3], c[:3] = [1 + 2 ** -23, 0.0, -1.0], [1 - 2 ** -23, 5.0, 0.0], [-1.0, -0.0, 1.0]
    got = pref.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    exact = [fractions.Fraction(float(x)) * fractions.Fraction(float(y)) + fractions.Fraction(float(z))
             for x, y, z in zip(a, b, c)]
    # The correctly rounded float32 of each exact value, by bracketing it.
    want = np.array([f32(float(e)) for e in exact], f32)
    for i, e in enumerate(exact):
        lo_hi = sorted({want[i], np.nextafter(want[i], f32(np.inf)), np.nextafter(want[i], f32(-np.inf))},
                       key=lambda v: abs(fractions.Fraction(float(v)) - e))
        want[i] = lo_hi[0]
    np.testing.assert_array_equal(got, want)
    assert got[0] == f32(-(2.0 ** -46))  # (1+u)(1-u) - 1, lost by two roundings
    assert np.float32(a[0] * b[0]) + c[0] == 0.0


def test_sqrt_rn_is_correctly_rounded():
    x = np.random.RandomState(1).rand(100_000).astype(f32) * 1e-3
    np.testing.assert_array_equal(pref.sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))


def test_adam_constants_rounded_as_the_reference():
    # Trouble spot: 1 - b1 is rounded once from float64, not computed in float32.
    assert pref.A1 == float(jnp.asarray(1.0 - 0.9, jnp.float32))
    assert pref.A2 == float(jnp.asarray(1.0 - 0.999, jnp.float32))
    assert pref.A1 != float(f32(1.0) - f32(0.9))
    assert (pref.B1, pref.B2, pref.EPS) == tuple(float(jnp.asarray(x, jnp.float32))
                                                for x in (0.9, 0.999, 1e-8))


def test_bias_corrections_bitwise_over_5000_steps():
    ts = np.arange(1, 5001, dtype=np.float32)
    want = jax.jit(lambda t: (1.0 - 0.9 ** t, 1.0 - 0.999 ** t))(jnp.asarray(ts))
    got = np.array([plpt.adam_bias_corrections(int(t)) for t in ts], f32).T
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("boundaries", [(), (3, 7), (1500, 2500)])
def test_learning_rate_bitwise_across_boundaries(boundaries):
    steps = np.arange(0, 3001, dtype=np.int32)
    ref_tr = jtr.CTRTrainer.__new__(jtr.CTRTrainer)
    ref_tr.cfg = jtr.TrainerConfig(spec=None, lr=3e-3, lr_boundaries=boundaries)
    want = np.asarray(jax.jit(jax.vmap(ref_tr._lr_at))(jnp.asarray(steps)))
    port = ptr.CTRTrainer.__new__(ptr.CTRTrainer)
    port.cfg = ptr.TrainerConfig(spec=None, dcn=None, lr=3e-3, lr_boundaries=boundaries)
    np.testing.assert_array_equal(np.array([port._lr_at(int(s)) for s in steps], f32), want)
    sched_want = np.asarray(jax.vmap(jsched.step_decay_schedule(3e-3, boundaries))(jnp.asarray(steps)))
    sched = psched.step_decay_schedule(3e-3, boundaries)
    np.testing.assert_array_equal(np.array([sched(int(s)) for s in steps], f32), sched_want)


def test_dedup_and_segment_sum_bitwise():
    rs = np.random.RandomState(7)
    ids = (rs.zipf(1.2, 3000) % 400).astype(np.int32).reshape(100, 30)
    ids[:, :5] = 17  # one id repeated over 500 times
    assert (ids == 17).sum() >= 500
    g = (rs.randn(ids.size, 15) * rs.lognormal(0, 3, (ids.size, 1))).astype(f32)
    juniq, jinv = jlpt.dedup_ids(jnp.asarray(ids), 500)
    want = jax.jit(lambda inv, g: jnp.zeros(g.shape, jnp.float32).at[inv].add(g))(jinv, g)
    uniq, inv = plpt.dedup_ids(torch.from_numpy(ids), 500)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert uniq.dtype == torch.int32 and (uniq.numpy()[len(np.unique(ids)):] == 500).all()
    got = plpt.segment_sum(torch.from_numpy(g), inv, ids.size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_fake_quant_lsq_forward_and_backward(bits):
    rs = np.random.RandomState(bits)
    w = (rs.randn(40, 16) * 0.05).astype(f32)
    step = rs.uniform(1e-3, 2e-2, 40).astype(f32)
    cot = rs.randn(40, 16).astype(f32)
    gscale = 1.0 / np.sqrt(40 * 16 * (2 ** (bits - 1) - 1))
    jfwd = jq.fake_quant_lsq(jnp.asarray(w), jnp.asarray(step), bits, gscale)
    jdw, jdstep = jax.grad(lambda w, s: jnp.sum(jq.fake_quant_lsq(w, s, bits, gscale) * cot),
                           (0, 1))(jnp.asarray(w), jnp.asarray(step))
    tw = torch.from_numpy(w).requires_grad_(True)
    ts = torch.from_numpy(step).requires_grad_(True)
    out = pq.fake_quant_lsq(tw, ts, bits, gscale)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jfwd))
    dw, dstep = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [tw, ts])
    np.testing.assert_array_equal(dw.numpy(), np.asarray(jdw))
    # XLA orders the per-row sum of 16 terms otherwise: a reordered float32
    # sum of d terms moves by at most about d * 2^-24 of the sum of |terms|
    # (each |term| <= |cot| * gscale * 2^(bits-1)), which bounds rows that
    # cancel; elsewhere that is rtol 1e-6.
    bound = 16 * 2.0 ** -24 * (np.abs(cot) * gscale * 2 ** (bits - 1)).sum(axis=1)
    np.testing.assert_array_less(np.abs(dstep.numpy() - np.asarray(jdstep)), bound + 1e-30)
    np.testing.assert_allclose(np.median(np.abs(dstep.numpy() / np.asarray(jdstep) - 1)), 0,
                               atol=1e-6)
    assert (np.abs(np.asarray(jdstep)) > 0).mean() > 0.9


@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
def test_adam_update_bitwise_vs_jitted_reference(weight_decay):
    rs = np.random.RandomState(5)
    shapes = [(24, 16), (16,), ()]
    params = [np.asarray(rs.randn(*s) * 1e-3, f32) for s in shapes]
    grads = [np.asarray(rs.randn(*s) * 0.1, f32) for s in shapes]
    mu = [np.asarray(rs.randn(*s) * 0.01, f32) for s in shapes]
    nu = [np.asarray(rs.rand(*s) * 1e-3, f32) for s in shapes]
    jstate = j_adam_init(params)._replace(step=jnp.asarray(6, jnp.int32), mu=mu, nu=nu)
    jp, js = jax.jit(lambda g, s, p: j_adam_update(g, s, p, f32(3e-3), weight_decay=weight_decay))(
        grads, jstate, params)
    pp, ps = adam_update([torch.from_numpy(g) for g in grads],
                         OptState(6, [torch.from_numpy(m) for m in mu],
                                  [torch.from_numpy(v) for v in nu]),
                         [torch.from_numpy(p) for p in params], float(f32(3e-3)),
                         weight_decay=weight_decay)
    assert ps.step == int(js.step) == 7
    for got, want in zip([*pp, *ps.mu, *ps.nu], [*jp, *js.mu, *js.nu]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fallbacks_are_counted_in_the_reference_schema():
    pops.reset_fallbacks()
    pops.note_fallback("sparse_row_update", (10, 16), "dr rounding")
    pops.note_fallback("sparse_row_update", (10, 16), "dr rounding")
    assert pops.fallbacks() == [{"op": "sparse_row_update", "shape": "(10, 16)",
                                 "reason": "dr rounding", "count": 2}]
    pops.reset_fallbacks()
    assert pops.fallbacks() == []
