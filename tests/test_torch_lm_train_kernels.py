"""Port parity for the LM training slice's write-back numerics (rungs 1-2).

The dense write-back kernels' plain versions (``lpt_fused_update(_packed)``,
``sr_round_seeded``), ``core.lpt.dense_apply`` and the ALPT dense pieces,
held against the JAX package run as it trains: jitted (XLA:CPU contracts the
write-back's multiply-adds into fused multiply-adds, and so does the
interpreted Pallas body), never eagerly.  Every comparison here is bitwise
unless its test says otherwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alpt as jalpt
from repro.core import codestore as jcs
from repro.core import lpt as jlpt
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import alpt as palpt
from repro_torch.core import lpt as plpt
from repro_torch.core.codestore import CodeStore, pack_codes, unpack_codes
from repro_torch.kernels import lpt_update as lpt_kernel
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import sr_round as sr_kernel

jax.config.update("jax_platform_name", "cpu")
f32 = np.float32


def _write_back_operands(seed, rows, cols, bits, *, adversarial=False):
    """Codes, Delta, a direction, noise and a new Delta for one write-back.
    ``adversarial`` sets each noise value to the fractional part of the
    element's unfused ``w' / Delta'``, so an SR decision flips when the port
    rounds ``w'`` one ulp differently from the reference."""
    rs = np.random.RandomState(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = rs.randint(lo, hi + 1, (rows, cols)).astype(np.int8)
    step = rs.uniform(1e-3, 0.05, rows).astype(f32)
    upd = (rs.randn(rows, cols) * 0.3).astype(f32)
    new_step = (step * rs.uniform(0.9, 1.1, rows)).astype(f32)
    noise = rs.rand(rows, cols).astype(f32)
    if adversarial:
        s = (codes.astype(f32) * step[:, None] - f32(0.0123) * upd) / new_step[:, None]
        noise = (s - np.floor(s)).astype(f32)
    return codes, step, upd, noise, new_step


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("has_new_step", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.37])
@pytest.mark.parametrize("adversarial", [False, True])
def test_lpt_fused_update_plain_matches_reference_kernel_and_oracle(bits, has_new_step,
                                                                   weight_decay, adversarial):
    """Rung 1 against both reference oracles at a tile-aligned shape: the
    interpreted Pallas kernel (``ops.lpt_update``) and the jitted jnp oracle
    (``use_kernel=False``); packed at bits 4 and 2."""
    codes, step, upd, noise, new_step = _write_back_operands(
        bits * 7 + has_new_step, 64, 32, bits, adversarial=adversarial)
    lr = f32(0.0123)
    ns = new_step if has_new_step else None
    jstore = jcs.CodeStore.from_codes(jnp.asarray(codes), bits)
    refs = []
    for use_kernel in (True, False):
        with jops.fallback_scope() as scope:
            out = jops.lpt_update(jstore, jnp.asarray(step), jnp.asarray(upd), jnp.asarray(noise),
                                  lr, bits, new_step=None if ns is None else jnp.asarray(ns),
                                  weight_decay=weight_decay, use_kernel=use_kernel)
        assert scope.stats()["kernel_calls"].get("lpt_update", 0) == int(use_kernel)
        refs.append(np.asarray(out.data))
    np.testing.assert_array_equal(refs[0], refs[1])  # the two oracles agree
    store = CodeStore.from_codes(torch.from_numpy(codes.copy()), bits)
    got = pops.lpt_update(store, torch.from_numpy(step), torch.from_numpy(upd),
                          torch.from_numpy(noise), float(lr), bits,
                          new_step=None if ns is None else torch.from_numpy(ns),
                          weight_decay=weight_decay)
    assert isinstance(got, CodeStore) and got.packed == (bits < 8)
    np.testing.assert_array_equal(got.data.numpy(), refs[0])


@pytest.mark.parametrize("rows,cols", [(37, 13), (36, 15), (5, 1)])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
def test_lpt_fused_update_plain_matches_the_jitted_oracle_on_ragged_shapes(rows, cols, bits,
                                                                          weight_decay):
    """Shapes the reference's kernel does not take run its jitted oracle
    (``ref.lpt_fused_update(_packed)_ref``); the port's plain version equals
    it bitwise, packed rows of odd width included."""
    codes, step, upd, noise, new_step = _write_back_operands(rows * cols + bits, rows, cols,
                                                             bits, adversarial=True)
    lr = f32(0.0123)
    jitted = jax.jit(jref.lpt_fused_update_ref, static_argnames=("bits", "weight_decay"))
    want = np.asarray(jitted(jnp.asarray(codes), jnp.asarray(step), jnp.asarray(upd),
                             jnp.asarray(noise), lr, bits=bits, new_step=jnp.asarray(new_step),
                             weight_decay=weight_decay))
    got = pref.lpt_fused_update_ref(torch.from_numpy(codes), torch.from_numpy(step),
                                    torch.from_numpy(upd), torch.from_numpy(noise), float(lr),
                                    bits, new_step=torch.from_numpy(new_step),
                                    weight_decay=weight_decay)
    np.testing.assert_array_equal(got.numpy(), want)
    if bits < 8:
        packed = pack_codes(torch.from_numpy(codes), bits)
        got_p = pref.lpt_fused_update_packed_ref(
            packed, torch.from_numpy(step), torch.from_numpy(upd), torch.from_numpy(noise),
            float(lr), bits, cols, new_step=torch.from_numpy(new_step),
            weight_decay=weight_decay)
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(jcs.pack_codes(want, bits)))
        np.testing.assert_array_equal(unpack_codes(got_p, bits, cols).numpy(), want)


def test_lpt_update_int8_store_and_raw_codes_agree():
    codes, step, upd, noise, _ = _write_back_operands(3, 16, 24, 8)
    args = (torch.from_numpy(step), torch.from_numpy(upd), torch.from_numpy(noise), 0.01, 8)
    raw = pops.lpt_update(torch.from_numpy(codes), *args)
    store = pops.lpt_update(CodeStore.from_codes(torch.from_numpy(codes), 8), *args)
    assert raw.dtype == torch.int8 and not store.packed
    np.testing.assert_array_equal(raw.numpy(), store.data.numpy())
    assert pops.kernel_calls() == {}  # CPU tensors take the plain version


# ------------------------------------------------------------ sr_round_seeded


def _philox_python(counter, key):
    """Philox4x32-10 on Python integers (Random123's definition)."""
    m0, m1, w0, w1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    c, k = list(counter), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + w0) & 0xFFFFFFFF, (k[1] + w1) & 0xFFFFFFFF]
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & 0xFFFFFFFF]
    return c


def test_philox_words_equal_a_python_integer_philox():
    # Random123's known-answer vectors, then random counters and keys: the
    # 16-bit split keeps every partial product of the torch version in int64.
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for counter, key, want in kat:
        assert tuple(_philox_python(counter, key)) == want
        got = pref.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in counter], key)
        assert tuple(int(w) for w in got) == want
    rs = np.random.RandomState(0)
    counters = rs.randint(0, 2 ** 32, (200, 4), dtype=np.uint64).astype(np.int64)
    for key in ((0, 0), (0xFFFFFFFF, 0), (12345, 0)):
        got = pref.philox4x32_10([torch.from_numpy(counters[:, j].copy()) for j in range(4)], key)
        got = torch.stack(got, 1).numpy()
        for i in range(0, 200, 7):
            assert tuple(got[i]) == tuple(_philox_python(tuple(int(c) for c in counters[i]), key))
    # The uniforms: word i % 4 of the block at counter i // 4, key (seed, 0).
    u = pref.philox_uniform(-7, 11).numpy()
    for i in range(11):
        word = _philox_python((i // 4, 0, 0, 0), (-7 & 0xFFFFFFFF, 0))[i % 4]
        assert u[i] == f32((word >> 8) * 2.0 ** -24)
    assert u.min() >= 0.0 and u.max() < 1.0


@pytest.mark.parametrize("rows,cols,bits", [(64, 32, 8), (37, 13, 4), (9, 7, 2)])
def test_sr_round_seeded_plain_is_sr_round_given_its_own_noise(rows, cols, bits):
    """With the Philox uniforms handed over as the noise operand, the seeded
    round equals the reference's jitted ``sr_round_ref`` bitwise."""
    rs = np.random.RandomState(rows)
    w = (rs.randn(rows, cols) * 0.05).astype(f32)
    step = rs.uniform(1e-3, 0.02, rows).astype(f32)
    for seed in (0, -1, 2 ** 31 - 1):
        got = pops.sr_round_seeded(torch.from_numpy(w), torch.from_numpy(step), seed, bits)
        u = pref.philox_uniform(seed, rows * cols).reshape(rows, cols).numpy()
        want = jax.jit(jref.sr_round_ref, static_argnums=3)(jnp.asarray(w), jnp.asarray(step),
                                                            jnp.asarray(u), bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sr_round_seeded_is_unbiased_over_seeds():
    """Mean code over 256 seeds within 5 sigma of w / Delta, sigma the standard
    error of a Bernoulli(frac) mean, sqrt(frac (1 - frac) / 256) <= 1/32 (and
    the same seed repeats its codes, two seeds differ)."""
    rs = np.random.RandomState(1)
    w = torch.from_numpy((rs.randn(50, 20) * 0.05).astype(f32))
    step = torch.from_numpy(rs.uniform(1e-3, 0.02, 50).astype(f32))
    draws = torch.stack([pops.sr_round_seeded(w, step, s, 8).to(torch.float64)
                         for s in range(256)])
    exact = torch.clamp(w.double() / step.double()[:, None], -128, 127)
    frac = exact - torch.floor(exact)
    sigma = torch.sqrt(frac * (1 - frac) / 256)
    assert bool((draws.mean(0) - exact).abs().le(5 * sigma + 1e-9).all())
    assert bool(((draws - exact).abs() < 1).all())  # one lattice step of w / Delta
    assert torch.equal(pops.sr_round_seeded(w, step, 5, 8), pops.sr_round_seeded(w, step, 5, 8))
    assert not torch.equal(pops.sr_round_seeded(w, step, 5, 8), pops.sr_round_seeded(w, step, 6, 8))


def test_reference_seeded_uniform_is_signed():
    """The reference's ``sr_round_seeded`` forms u from ``prng_random_bits``,
    typed int32, with ``>>``: an arithmetic shift, so a word with its top bit
    set gives u < 0 and u spans [-0.5, 0.5) (ROADMAP Queue C).  The port's
    uniform shifts the unsigned word."""
    bits = jnp.asarray([-1, -(2 ** 31), 2 ** 31 - 1], jnp.int32)
    u = np.asarray((bits >> 8).astype(jnp.float32) * (1.0 / (1 << 24)))
    np.testing.assert_array_equal(u, np.array([-2.0 ** -24, -0.5, 0.5 - 2.0 ** -24], f32))
    words = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.int64)
    port = (torch.from_numpy(words) >> 8).to(torch.float32) * f32(2.0 ** -24)
    assert port.min() >= 0.0 and port.max() < 1.0


# --------------------------------------------------------------- dense paths


def _tables(seed, n, d, bits, *, optimizer="adam", zero_rows=True):
    """A reference LPTTable and the port's copy, a dense gradient with zero
    (untouched) rows, and the reference's SR noise for it."""
    rs = np.random.RandomState(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = rs.randint(lo, hi + 1, (n, d)).astype(np.int8)
    step = rs.uniform(1e-3, 0.05, n).astype(f32)
    slot = (n, d) if optimizer == "adam" else (n,)
    mu = (rs.randn(*slot) * 0.01).astype(f32) if optimizer == "adam" else np.zeros(slot, f32)
    nu = (rs.rand(*slot) * 1e-3).astype(f32)
    grad = (rs.randn(n, d) * 0.1).astype(f32)
    if zero_rows:
        grad[rs.rand(n) < 0.4] = 0.0
    count = 6
    jtable = jlpt.LPTTable(codes=jcs.CodeStore.from_codes(jnp.asarray(codes), bits),
                           step=jnp.asarray(step), mu=jnp.asarray(mu), nu=jnp.asarray(nu),
                           count=jnp.asarray(count, jnp.int32))
    ptable = plpt.LPTTable(codes=CodeStore.from_codes(torch.from_numpy(codes.copy()), bits),
                           step=torch.from_numpy(step.copy()), mu=torch.from_numpy(mu.copy()),
                           nu=torch.from_numpy(nu.copy()), count=count)
    return jtable, ptable, grad


def _assert_tables_equal(p, j):
    np.testing.assert_array_equal(p.codes.data.numpy(), np.asarray(j.codes.data))
    for name in ("step", "mu", "nu"):
        np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert p.count == int(j.count)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(64, 32), (37, 13)])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("has_new_step", [False, True])
def test_dense_apply_bitwise_vs_jitted_reference(bits, shape, weight_decay, use_kernels,
                                                 has_new_step):
    """Rung 2: one dense LPT step (row-Adam, SR) from the reference's table,
    gradient, lr and ``sr_noise`` gives the reference's table bit for bit —
    codes, Delta, mu, nu — untouched rows included; kernels on (the write-back
    kernel's plain version) and off (the plain row update + quantizer)."""
    n, d = shape
    jtable, ptable, grad = _tables(n + bits, n, d, bits)
    key = jax.random.PRNGKey(bits)
    lr = f32(3e-3)
    new_step = (np.asarray(jtable.step) * f32(1.03)).astype(f32) if has_new_step else None
    fn = jax.jit(functools.partial(jlpt.dense_apply, bits=bits, rounding="sr", optimizer="adam",
                                   weight_decay=weight_decay, use_kernels=use_kernels))
    want = fn(jtable, jnp.asarray(grad), lr=lr, noise_key=key,
              new_step=None if new_step is None else jnp.asarray(new_step))
    noise = torch.from_numpy(np.asarray(jq.sr_noise(key, (n, d))))
    got = plpt.dense_apply(ptable, torch.from_numpy(grad), lr=float(lr), bits=bits, noise=noise,
                           optimizer="adam", weight_decay=weight_decay,
                           new_step=None if new_step is None else torch.from_numpy(new_step),
                           use_kernels=use_kernels)
    _assert_tables_equal(got, want)
    untouched = ~(grad != 0).any(-1)
    assert untouched.sum() > 3
    np.testing.assert_array_equal(got.codes.data.numpy()[untouched],
                                  ptable.codes.data.numpy()[untouched])


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_dense_apply_other_row_optimizers(optimizer):
    jtable, ptable, grad = _tables(5, 40, 16, 8, optimizer=optimizer)
    key = jax.random.PRNGKey(2)
    lr = f32(1e-2)
    fn = jax.jit(functools.partial(jlpt.dense_apply, bits=8, optimizer=optimizer,
                                   use_kernels=False))
    want = fn(jtable, jnp.asarray(grad), lr=lr, noise_key=key)
    got = plpt.dense_apply(ptable, torch.from_numpy(grad), lr=float(lr), bits=8,
                           noise=torch.from_numpy(np.asarray(jq.sr_noise(key, (40, 16)))),
                           optimizer=optimizer)
    np.testing.assert_array_equal(got.codes.data.numpy(), np.asarray(want.codes.data))
    np.testing.assert_allclose(got.nu.numpy(), np.asarray(want.nu), rtol=1e-6)


@pytest.mark.parametrize("bits, kernel", [(8, "lpt_fused_update"),
                                          (4, "lpt_fused_update_packed")])
def test_dense_apply_dr_is_a_counted_fallback(bits, kernel):
    """DR skips the write-back kernel; the fallback is counted under the
    name of the kernel it skipped."""
    jtable, ptable, grad = _tables(6, 16, 8, bits)
    assert ptable.codes.packed == (bits < 8)
    pops.reset_fallbacks()
    want = jax.jit(functools.partial(jlpt.dense_apply, bits=bits, rounding="dr"))(
        jtable, jnp.asarray(grad), lr=f32(1e-2))
    got = plpt.dense_apply(ptable, torch.from_numpy(grad), lr=1e-2, bits=bits, rounding="dr",
                           use_kernels=True)
    _assert_tables_equal(got, want)
    assert pops.fallbacks() == [{"op": kernel, "shape": "(16, 8)", "reason": "dr rounding",
                                 "count": 1}]
    pops.reset_fallbacks()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
def test_alpt_dense_weight_update_and_finish_bitwise(bits, weight_decay):
    """``dense_weight_update`` (the float rows, mu, nu) against the jitted
    reference; ``dense_finish`` bitwise given the reference's update, its
    Delta gradient and its ``sr_noise(fold_in(kn, 1))``, kernels on and off."""
    n, d = 48, 24
    jtable, ptable, grad = _tables(bits + 11, n, d, bits)
    cfg = dict(bits=bits, weight_decay=weight_decay, step_lr=2e-3, step_weight_decay=5e-8)
    lr = f32(2e-3)
    jupd = jax.jit(functools.partial(jalpt.dense_weight_update, cfg=jalpt.ALPTConfig(**cfg)))(
        jtable, jnp.asarray(grad), lr=lr)
    pupd = palpt.dense_weight_update(ptable, torch.from_numpy(grad),
                                     cfg=palpt.ALPTConfig(**cfg), lr=float(lr))
    for name in ("mu_new", "nu_new", "touched"):
        np.testing.assert_array_equal(getattr(pupd, name).numpy(), np.asarray(getattr(jupd, name)),
                                      err_msg=name)
    got, want = pupd.w_new.numpy(), np.asarray(jupd.w_new)
    if bits == 8:
        np.testing.assert_array_equal(got, want)
    else:
        # Over the packed table XLA fuses the unpack with the update and forms
        # the Adam quotient's numerator as the stored mu' (fma(b1, mu, (1-b1) g))
        # on some elements; the port keeps the int8 table's arithmetic
        # (ROADMAP Queue C).  An ulp of the direction, then the rounding of
        # lr * upd, move w_new by at most two ulps of its larger term (the old
        # weight or the new one).
        w_old = np.asarray(jtable.codes.unpack()).astype(f32) * np.asarray(jtable.step)[:, None]
        bound = 2.0 ** -21 * np.maximum(np.abs(w_old), np.abs(want))
        assert (np.abs(got - want) <= bound).all() and (got != want).mean() <= 0.03
    rs = np.random.RandomState(4)
    g_step = (rs.randn(n) * 5.0).astype(f32)
    key = jax.random.PRNGKey(9)
    noise = torch.from_numpy(np.asarray(jq.sr_noise(jax.random.fold_in(key, 1), (n, d))))
    ref_upd = palpt.DenseWeightUpdate(
        w_new=torch.from_numpy(np.array(jupd.w_new)), mu_new=torch.from_numpy(np.array(jupd.mu_new)),
        nu_new=torch.from_numpy(np.array(jupd.nu_new)),
        touched=torch.from_numpy(np.array(jupd.touched)), count=int(jupd.count))
    for use_kernels in (True, False):
        jcfg = jalpt.ALPTConfig(**cfg, use_kernels=use_kernels)
        want = jax.jit(functools.partial(jalpt.dense_finish, cfg=jcfg))(
            jtable, jupd, jnp.asarray(g_step), noise_key=key)
        pcfg = palpt.ALPTConfig(**cfg, use_kernels=use_kernels)
        got = palpt.dense_finish(ptable, ref_upd, torch.from_numpy(g_step), cfg=pcfg, noise=noise)
        _assert_tables_equal(got, want)
        untouched = ~ref_upd.touched.numpy()
        np.testing.assert_array_equal(got.step.numpy()[untouched],
                                      ptable.step.numpy()[untouched])


def test_alpt_dense_finish_delta_step_is_fused_as_the_reference():
    """The Delta step ``step - lr_D (g + wd_D step)`` at constants large enough
    for each rounding to show: XLA:CPU computes two fused multiply-adds."""
    jtable, ptable, grad = _tables(19, 480, 24, 8)
    cfg = dict(bits=8, step_lr=0.21, step_weight_decay=0.37)
    jupd = jax.jit(functools.partial(jalpt.dense_weight_update, cfg=jalpt.ALPTConfig(**cfg)))(
        jtable, jnp.asarray(grad), lr=f32(2e-3))
    pupd = palpt.dense_weight_update(ptable, torch.from_numpy(grad),
                                     cfg=palpt.ALPTConfig(**cfg), lr=2e-3)
    key = jax.random.PRNGKey(1)
    noise = torch.from_numpy(np.asarray(jq.sr_noise(jax.random.fold_in(key, 1), (480, 24))))
    for scale in (5.0, 0.05, 1e-3):
        g_step = (np.random.RandomState(4).randn(480) * scale).astype(f32)
        want = jax.jit(functools.partial(jalpt.dense_finish, cfg=jalpt.ALPTConfig(**cfg)))(
            jtable, jupd, jnp.asarray(g_step), noise_key=key)
        got = palpt.dense_finish(ptable, pupd, torch.from_numpy(g_step),
                                 cfg=palpt.ALPTConfig(**cfg), noise=noise)
        np.testing.assert_array_equal(got.step.numpy(), np.asarray(want.step))


def test_alpt_dense_delta_grad_matches_jax_grad():
    """Rung 3: the Delta gradient through ``fake_quant_lsq`` of a loss of the
    whole table, against ``jax.grad`` through the reference's; within 1e-5
    relative (sums over the row in another order)."""
    n, d, bits = 40, 16, 8
    rs = np.random.RandomState(3)
    w_new = (rs.randn(n, d) * 0.05).astype(f32)
    step = rs.uniform(5e-4, 2e-3, n).astype(f32)
    target = rs.randn(n, d).astype(f32)

    def jloss(t):
        return jnp.sum(jnp.tanh(t * 7.0) * target)

    def ploss(t):
        return torch.sum(torch.tanh(t * 7.0) * torch.from_numpy(target))

    cfg = dict(bits=bits)
    want = jax.jit(lambda w, s: jalpt.dense_delta_grad(w, s, jloss, cfg=jalpt.ALPTConfig(**cfg),
                                                        gscale=0.01))(w_new, step)
    got = palpt.dense_delta_grad(torch.from_numpy(w_new), torch.from_numpy(step), ploss,
                                 cfg=palpt.ALPTConfig(**cfg), gscale=0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert np.abs(np.asarray(want)).max() > 1e-3


# ----------------------------------------------------- the wrappers and guard


def test_write_back_wrappers_refuse_what_the_kernels_do_not_take():
    codes = torch.zeros(8, 16, dtype=torch.int8)
    step, upd = torch.ones(8), torch.zeros(8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lpt_kernel.lpt_fused_update(codes, step, upd, upd, 0.1, 8)
    with pytest.raises(ValueError, match="bits must be 2 or 4"):
        lpt_kernel.lpt_fused_update_packed(codes.view(torch.uint8), step, upd, upd, 0.1, 8, 16)
    with pytest.raises(ValueError, match="bits must be in"):
        lpt_kernel.lpt_fused_update(codes, step, upd, upd, 0.1, 9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sr_kernel.sr_round_seeded(upd, step, 3, 8)
    with pytest.raises(ValueError, match="int32"):
        sr_kernel.sr_round_seeded(upd, step, 2 ** 31, 8)


def test_forward_only_wrappers_raise_under_autograd():
    """The gather, head and attention dispatchers refuse an input that
    requires grad while grad mode is on (their CUDA kernels have no backward),
    on the CPU as on the card, and run under ``no_grad``."""
    codes = torch.zeros(8, 16, dtype=torch.int8)
    step = torch.ones(8, requires_grad=True)
    ids = torch.zeros(3, dtype=torch.int32)
    x = torch.zeros(2, 16, requires_grad=True)
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    kv = torch.zeros(1, 4, 1, 8)
    calls = [
        lambda: pops.dequant_gather(codes, step, ids),
        lambda: pops.dequant_gather(CodeStore.from_codes(codes, 4), step, ids),
        lambda: pops.dequant_matmul(x, codes, step.detach()),
        lambda: pops.dequant_matmul(x, CodeStore.from_codes(codes, 2), step.detach()),
        lambda: pops.flash_attention_fwd(q, kv, kv),
        lambda: pops.flash_attention_fwd(q, kv, kv, use_kernel=False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward only"):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()).all()
        with torch.inference_mode():
            call()
