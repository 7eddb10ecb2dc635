"""Port parity for the training slice: LPT's sparse step (rung 2), ALPT's step
(rung 2 for line 5, rung 3 for the whole step), the trainer against the
reference's over 10 steps, and the state carried across in both directions.

The reference runs jitted, as it trains (its eager run rounds otherwise; see
tests/test_torch_train_kernels.py).  SR noise is drawn from the reference's
keys and handed to the port.  Comparisons look at live rows ``[:spec.n]``:
the scratch row of a ``pad_to_tiles`` table is unspecified on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alpt as jalpt
from repro.core import codestore as jcs
from repro.core import lpt as jlpt
from repro.core import quant as jq
from repro.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro.methods import EmbeddingSpec as JSpec
from repro.models import ctr as jctr
from repro.training import ctr_trainer as jtr
from repro_torch import interop
from repro_torch.core import alpt as palpt
from repro_torch.core import lpt as plpt
from repro_torch.core.codestore import CodeStore
from repro_torch.kernels import ops as pops
from repro_torch.methods import EmbeddingSpec as PSpec
from repro_torch.models import ctr as pctr
from repro_torch.training import ctr_trainer as ptr

f32 = np.float32
DATA_CFG = CTRDatasetConfig(name="t", n_fields=6, cardinalities=(40, 9, 300, 17, 5, 100),
                            teacher_rank=4)
DATA = CTRSynthetic(DATA_CFG)
DCN_KW = dict(n_fields=6, emb_dim=8, cross_depth=2, mlp_widths=(32, 16))


def _np(x):
    return np.array(x)


def _table(seed, n, d, bits, *, packed=True):
    """A reference LPTTable with nonzero Adam slots, and its port twin."""
    rs = np.random.RandomState(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = rs.randint(lo, hi + 1, (n, d)).astype(np.int8)
    step = rs.uniform(2e-3, 0.03, n).astype(f32)
    mu = (rs.randn(n, d) * 1e-3).astype(f32)
    nu = (rs.rand(n, d) * 1e-4).astype(f32)
    jt = jlpt.LPTTable(codes=jcs.CodeStore.from_codes(jnp.asarray(codes), bits, packed=packed),
                       step=jnp.asarray(step), mu=jnp.asarray(mu), nu=jnp.asarray(nu),
                       count=jnp.asarray(4, jnp.int32))
    pt = plpt.LPTTable(codes=CodeStore.from_codes(torch.from_numpy(codes), bits, packed=packed),
                       step=torch.from_numpy(step.copy()), mu=torch.from_numpy(mu.copy()),
                       nu=torch.from_numpy(nu.copy()), count=4)
    return jt, pt


def _assert_live_equal(pt, jt, n_live):
    np.testing.assert_array_equal(pt.codes.data.numpy()[:n_live], _np(jt.codes.data)[:n_live])
    for name in ("step", "mu", "nu"):
        np.testing.assert_array_equal(getattr(pt, name).numpy()[:n_live],
                                      _np(getattr(jt, name))[:n_live], err_msg=name)
    assert pt.count == int(jt.count)


@pytest.mark.parametrize("bits,packed", [(8, True), (4, True), (4, False), (2, True)])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
def test_lpt_sparse_apply_one_step_bitwise(bits, packed, use_kernels, pad, weight_decay):
    n_live, d = 60, 16
    n = n_live + 4 if pad else n_live
    jt, pt = _table(bits + 10 * pad, n, d, bits, packed=packed)
    rs = np.random.RandomState(3)
    ids = np.minimum(rs.zipf(1.4, (16, 5)), n_live).astype(np.int32) - 1
    g_rows = (rs.randn(16, 5, d) * 0.05).astype(f32)
    key = jax.random.PRNGKey(11)
    noise = _np(jq.sr_noise(key, (ids.size, d)))
    lr = f32(0.01)

    @jax.jit
    def ref_step(table, ids, g_rows):
        return jlpt.sparse_apply(table, ids, g_rows, lr=lr, bits=bits, noise_key=key,
                                 weight_decay=weight_decay, return_updated_rows=True,
                                 id_space=n_live, use_kernels=use_kernels)

    jt2, (juniq, jw) = ref_step(jt, jnp.asarray(ids), jnp.asarray(g_rows))
    pops.reset_fallbacks()
    pops.reset_kernel_calls()
    pt2, (puniq, pw, pinv) = plpt.sparse_apply(
        pt, torch.from_numpy(ids), torch.from_numpy(g_rows), lr=float(lr), bits=bits,
        noise=torch.from_numpy(noise), weight_decay=weight_decay, return_updated_rows=True,
        id_space=n_live, use_kernels=use_kernels)
    # Scratch row or none, the kernel path takes the step: nothing falls back.
    assert pops.fallbacks() == []
    assert pops.kernel_calls() == {}  # CPU tensors take the plain versions
    np.testing.assert_array_equal(puniq.numpy()[pinv.numpy()], ids.ravel())
    assert pt2.codes.data is pt.codes.data  # updated in place
    _assert_live_equal(pt2, jt2, n_live)
    np.testing.assert_array_equal(puniq.numpy(), _np(juniq))
    real = puniq.numpy() < n_live
    np.testing.assert_array_equal(pw.numpy()[real], _np(jw)[real])


def test_lpt_sparse_apply_dr_and_adagrad_take_counted_fallbacks():
    n, d = 40, 8
    jt, pt = _table(1, n + 8, d, 8)
    ids = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    g = torch.ones(3, 4, d) * 0.1
    pops.reset_fallbacks()
    plpt.sparse_apply(pt, ids, g, lr=0.01, bits=8, rounding="dr", id_space=n, use_kernels=True)
    slots = torch.zeros(n + 8)
    plpt.sparse_apply(pt._replace(mu=slots.clone(), nu=slots.clone()), ids, g, lr=0.01, bits=8,
                      noise=torch.rand(12, d), optimizer="adagrad", id_space=n, use_kernels=True)
    assert [f["reason"] for f in pops.fallbacks()] == ["dr rounding", "row optimizer 'adagrad'"]


def _dcn_pair(seed):
    jp = jctr.init_dcn(jax.random.PRNGKey(seed), jctr.DCNConfig(**DCN_KW))
    pm = pctr.DCN(pctr.DCNConfig(**DCN_KW)).load_jax_params(jax.tree.map(_np, jp))
    return jp, pm


@pytest.mark.parametrize("bits", [8, 4])
def test_alpt_step_line5_bitwise_and_whole_step_rung3(bits):
    n_live, d = 608, 8
    jt, pt = _table(bits, n_live + 8, d, bits)
    ids, labels = DATA.batch("train", 0, 64)
    jp, pm = _dcn_pair(0)
    cfg = jalpt.ALPTConfig(bits=bits, step_lr=2e-4, use_kernels=True)
    key = jax.random.PRNGKey(5)
    noise = (_np(jq.sr_noise(key, (ids.size, d))),
             _np(jq.sr_noise(jax.random.fold_in(key, 1), (ids.size, d))))

    def jloss(rows):
        return jctr.bce_loss(jctr.logits_from_rows(jp, rows, jctr.DCNConfig(**DCN_KW)), labels)

    lr = f32(3e-3)
    jt_pre = jax.jit(lambda t: jlpt.sparse_apply(
        t, jnp.asarray(ids), jax.grad(jloss)(jlpt.lookup(t, jnp.asarray(ids))), lr=lr, bits=bits,
        noise_key=key, weight_decay=cfg.weight_decay, return_updated_rows=True,
        id_space=n_live, use_kernels=True))(jt)[1]
    jt2, jl, jaux = jax.jit(lambda t: jalpt.alpt_step(
        t, jnp.asarray(ids), jloss, cfg=cfg, lr=lr, noise_key=key, id_space=n_live,
        out_dim=d))(jt)

    # Line 5 alone, given the reference's w_new, new Delta and noise: bitwise.
    uniq, w_new = _np(jt_pre[0]), _np(jt_pre[1])
    new_step_b = _np(jt2.step)[np.minimum(uniq, n_live + 7)]
    _, line5 = _table(bits, n_live + 8, d, bits)
    codes_rows = pops.sr_round(torch.from_numpy(w_new), torch.from_numpy(new_step_b),
                               torch.from_numpy(noise[1]), bits)
    line5.codes.set_rows(torch.from_numpy(uniq), codes_rows)
    real = np.unique(uniq[uniq < n_live])
    np.testing.assert_array_equal(line5.codes.unpack().numpy()[real],
                                  _np(jt2.codes.unpack())[real])

    # The whole step from the same state and noise (rung 3: through the DCN).
    tlabels = torch.from_numpy(labels)
    pt2, aux = palpt.alpt_step(
        pt, torch.from_numpy(ids), _port_row_grads(pt, ids, pm, tlabels, d),
        lambda rows: pctr.bce_loss(pm(rows), tlabels),
        cfg=palpt.ALPTConfig(bits=bits, step_lr=2e-4, use_kernels=True), lr=float(lr),
        noise=tuple(torch.from_numpy(x) for x in noise), id_space=n_live, out_dim=d)
    live = slice(0, n_live)
    np.testing.assert_allclose(pt2.step.numpy()[live], _np(jt2.step)[live], rtol=1e-5)
    assert not np.array_equal(pt2.step.numpy()[real], _np(jt.step)[real])  # Delta moved
    diff = pt2.codes.unpack().numpy()[live].astype(int) - _np(jt2.codes.unpack())[live]
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-3
    np.testing.assert_allclose(float(aux["mean_step"]), float(jaux["mean_step"]), rtol=1e-5)


def _port_row_grads(pt, ids, model, labels, d):
    rows = plpt.lookup(pt, torch.from_numpy(ids), out_dim=d).requires_grad_(True)
    (g,) = torch.autograd.grad(pctr.bce_loss(model(rows), labels), [rows])
    return g


def _trainers(method, bits, *, pad, lr_boundaries=(), **spec_kw):
    kw = dict(method=method, n=DATA_CFG.n_features, d=8, bits=bits, init_scale=0.05,
              pad_to_tiles=pad, **spec_kw)
    jcfg = jtr.TrainerConfig(spec=JSpec(**kw), model="dcn", dcn=jctr.DCNConfig(**DCN_KW),
                             lr=3e-3, lr_boundaries=lr_boundaries)
    pcfg = ptr.TrainerConfig(spec=PSpec(**kw), dcn=pctr.DCNConfig(**DCN_KW), lr=3e-3,
                             lr_boundaries=lr_boundaries)
    return jtr.CTRTrainer(jcfg), jcfg, ptr.CTRTrainer(pcfg, device="cpu"), pcfg


def _port_state_of(pcfg, js):
    t = js.emb_state
    return interop.state_from_numpy(
        pcfg, codes=_np(t.codes.data), step=_np(t.step), mu=_np(t.mu), nu=_np(t.nu),
        count=int(t.count), train_step=int(js.step),
        dense_params=jax.tree.map(_np, js.dense_params),
        dense_opt={"step": int(js.dense_opt.step), "mu": jax.tree.map(_np, js.dense_opt.mu),
                   "nu": jax.tree.map(_np, js.dense_opt.nu)},
        device="cpu")


def _reference_noise(js, k, d):
    """The reference step's draws: ``rng, kd, kn = split(state.rng, 3)``."""
    kn = jax.random.split(js.rng, 3)[2]
    return [torch.from_numpy(_np(jq.sr_noise(kn, (k, d)))),
            torch.from_numpy(_np(jq.sr_noise(jax.random.fold_in(kn, 1), (k, d))))]


@pytest.mark.parametrize("method,bits,pad", [("alpt", 8, False), ("alpt", 4, True),
                                             ("lpt", 8, True)])
def test_trainer_losses_match_reference_over_10_steps(method, bits, pad):
    jt, jcfg, pt, pcfg = _trainers(method, bits, pad=pad, lr_boundaries=(6,),
                                   **({"clip_value": 0.1} if method == "lpt" else {}))
    js = jt.init_state()
    ps = _port_state_of(pcfg, js)
    n, d = pcfg.spec.n, pcfg.spec.d_padded
    jl, pl = [], []
    for i in range(10):
        ids, labels = DATA.batch("train", i, 64)
        noise = _reference_noise(js, ids.size, d)
        js, jm = jt.train_step(js, ids, labels)
        ps, pm = pt.train_step(ps, ids, labels, noise=noise[: pt.method.noise_draws])
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
        assert pm["lr"] == float(jm["lr"])
    # The DCN backward sums in another order than XLA's (rung 3), so the
    # dense params and row gradients drift by ulps; an SR code flips only
    # where w/Delta lands within that of the noise draw.
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    codes_j = _np(js.emb_state.codes.unpack())[:n]
    codes_p = ps.emb_state.codes.unpack().numpy()[:n]
    assert (codes_j != codes_p).mean() <= 1e-3
    np.testing.assert_allclose(ps.emb_state.step.numpy()[:n], _np(js.emb_state.step)[:n],
                               rtol=1e-5)
    assert ps.step == int(js.step) == 10 and ps.emb_state.count == int(js.emb_state.count)


def test_trainer_kernel_path_equals_plain_path_on_cpu():
    """use_kernels on (the row step through ops, plain on the CPU) and off
    (core.lpt's own plain path) give the same state bit for bit."""
    _, _, pt, pcfg = _trainers("alpt", 4, pad=True)
    states = []
    for use_kernels in (True, False):
        cfg = dataclasses.replace(pcfg, spec=dataclasses.replace(pcfg.spec, use_kernels=use_kernels))
        tr = ptr.CTRTrainer(cfg, device="cpu")
        s = tr.init_state()
        losses = []
        for i in range(4):
            ids, labels = DATA.batch("train", i, 32)
            s, m = tr.train_step(s, ids, labels)
            losses.append(float(m["loss"]))
        states.append((s, losses))
    (a, la), (b, lb) = states
    assert la == lb
    _assert_live_equal(a.emb_state, b.emb_state, pcfg.spec.n)


def test_untouched_rows_stay_bit_identical():
    _, _, pt, pcfg = _trainers("alpt", 8, pad=True)
    s0 = pt.init_state()
    before = ptr.clone_state(s0)
    s, touched = s0, set()
    for i in range(3):
        ids, labels = DATA.batch("train", i, 16)
        touched |= set(ids.ravel().tolist())
        s, _ = pt.train_step(s, ids, labels)
    rows = np.setdiff1d(np.arange(pcfg.spec.n), sorted(touched))
    assert len(rows) > 100
    for name in ("step", "mu", "nu"):
        np.testing.assert_array_equal(getattr(s.emb_state, name).numpy()[rows],
                                      getattr(before.emb_state, name).numpy()[rows])
    np.testing.assert_array_equal(s.emb_state.codes.data.numpy()[rows],
                                  before.emb_state.codes.data.numpy()[rows])
    touched = sorted(touched)
    assert (s.emb_state.mu.numpy()[touched] != 0).any(axis=1).all()


def test_state_round_trips_a_reference_state_after_3_steps():
    jt, jcfg, pt, pcfg = _trainers("alpt", 4, pad=True)
    js = jt.init_state()
    for i in range(3):
        js, _ = jt.train_step(js, *DATA.batch("train", i, 32))
    ps = _port_state_of(pcfg, js)
    back = interop.state_to_numpy(pcfg, ps)
    t = js.emb_state
    for name, want in (("codes", t.codes.data), ("step", t.step), ("mu", t.mu), ("nu", t.nu)):
        np.testing.assert_array_equal(back[name], _np(want), err_msg=name)
    assert back["count"] == int(t.count) == 3 and back["train_step"] == 3
    for got, want in ((back["dense_params"], js.dense_params),
                      (back["dense_opt"]["mu"], js.dense_opt.mu),
                      (back["dense_opt"]["nu"], js.dense_opt.nu)):
        jax.tree.map(np.testing.assert_array_equal, got, jax.tree.map(_np, want))
    assert back["dense_opt"]["step"] == int(js.dense_opt.step) == 3


def test_memory_bytes_counts_the_container():
    _, _, pt, pcfg = _trainers("alpt", 4, pad=True)
    table = pt.init_state().emb_state
    n, d = pcfg.spec.n_padded, pcfg.spec.d_padded
    assert plpt.memory_bytes(table, 4) == n * (d // 2) + n * 4
    assert plpt.memory_bytes(table, 4, count_optimizer=True) == n * (d // 2) + n * 4 + 2 * n * d * 4
    assert pt.method.memory_bytes(table, pcfg.spec) == plpt.memory_bytes(table, 4)
