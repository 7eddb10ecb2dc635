"""The port's data-parallel trainer pieces against the JAX package's (``repro/training/data_parallel.py``), on the CPU, at the
reference test's mini size (6 fields, cardinalities (17, 29, 11, 41, 13,
23), d = 8, DCN 2 cross layers, MLP 32/16, batch 64) and SmolLM's smoke
config cut to one layer.  The collectives, the n-rank steps and the CLI:
tests/test_torch_data_parallel.py; the microbatched CTR step against the
reference's: tests/test_torch_data_parallel_steps.py, with these fixtures.

The ladder, each rung with its tolerance:

- rung 2, bitwise: ``CTRTrainer.build_apply_fn`` and the LM ``apply_fn``
  from the reference's state, given its gradients, its SR draws and one
  Delta gradient on both sides (the LM with a clip that never binds: the
  global norm sums the leaves in another order);
- rung 3: ``build_grad_fn`` against the reference's, loss within rtol 1e-6
  and gradients within 2e-6 of each leaf's largest entry (the DCN's
  backward sums in another order), and synced at 8 bits with the
  reference's noise within one sync step of its sync (each rank's SR code
  flips where its gradient lands within an ulp of the noise);
- ``make_lm_microbatch_step`` for fp / lpt / alpt against the reference's
  (2 shards, 2 steps, handed its noise): losses within rtol 1e-6 at 32
  bits and 1e-5 at 8 (measured 1.2e-6: an SR code flip in one param's
  synced gradient moves that param by up to lr through Adam), the tables'
  codes equal but for <= 1e-3 of them, within 1e-5 as floats.

The reference runs jitted with kernels off (its own kernels-on ==
kernels-off contract; its ``test_kernel_parity_ctr_dense_microbatched``
fails for mixed and qr_lpt); the port takes the plain versions on the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import methods as jmethods
from repro.core import hashing as jhash
from repro.core import quant as jq
from repro.core.alpt import ALPTConfig as JALPTConfig
from repro.models import ctr as jctr
from repro.training import ctr_trainer as jtr
from repro.training import data_parallel as jdp
from repro.training import lm_trainer as jlm
from repro_torch import configs, interop, methods
from repro_torch.core.alpt import ALPTConfig
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.models import ctr as pctr
from repro_torch.optim import tree_leaves, tree_like
from repro_torch.training import ctr_trainer as ptr
from repro_torch.training import data_parallel as dpm
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")
f32 = np.float32
SEED = 0  # DPConfig.sync_seed on both sides
CARDS = (17, 29, 11, 41, 13, 23)
DCN_KW = dict(n_fields=6, emb_dim=8, cross_depth=2, mlp_widths=(32, 16))
DATA = CTRSynthetic(CTRDatasetConfig(name="mini", n_fields=6, cardinalities=CARDS,
                                     teacher_rank=4, seed=3))
N_FEATURES = sum(CARDS)
BATCH = 64


def _np(x):
    return np.array(x)


def to_np(x):
    """A reference state as ``methods.layout``'s nested numpy layout."""
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if hasattr(x, "data") and hasattr(x, "packed"):
        return np.array(x.data)
    if isinstance(x, (tuple, list)):
        return [to_np(v) for v in x]
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    return np.array(x)


@functools.partial(jax.jit, static_argnums=(2,))
def _ref_draw(path, rank, shape):
    key = jax.random.PRNGKey(SEED)
    for j in range(path.shape[0]):
        key = jax.random.fold_in(key, path[j])
    return jq.sr_noise(jax.random.fold_in(key, rank), shape)


def ref_sync_noise(path, rank, shape, device):
    """The reference's sync noise: ``sr_noise(fold_in(fold_in(fold_in(
    PRNGKey(seed), step), leaf), rank))`` for the path (step, leaf)."""
    return torch.from_numpy(_np(_ref_draw(jnp.asarray(path, jnp.int32), rank, tuple(shape))))


# ------------------------------------------------------------ CTR fixtures


def _ctr_pair(method, *, sync_bits=32, pad=False):
    """(reference trainer, its state, port trainer, its state from the reference's)."""
    kw = dict(method=method, n=N_FEATURES, d=8, bits=8, init_scale=0.05, pad_to_tiles=pad,
              field_cards=CARDS, field_bits=(8, 4, 8, 2, 8, 4))
    jcfg = jtr.TrainerConfig(
        spec=jmethods.EmbeddingSpec(**kw, alpt=JALPTConfig(bits=8, step_lr=2e-4),
                                    use_kernels=False),
        model="dcn", dcn=jctr.DCNConfig(**DCN_KW), lr=1e-3, dp_sync_bits=sync_bits)
    pcfg = ptr.TrainerConfig(spec=methods.EmbeddingSpec(**kw, alpt=ALPTConfig(bits=8,
                                                                              step_lr=2e-4)),
                             dcn=pctr.DCNConfig(**DCN_KW), lr=1e-3, dp_sync_bits=sync_bits)
    jt, pt = jtr.CTRTrainer(jcfg), ptr.CTRTrainer(pcfg, device="cpu")
    js = jt.init_state()
    ps = interop.state_from_numpy(pcfg, emb_state=to_np(js.emb_state),
                                  dense_params=jax.tree.map(_np, js.dense_params), device="cpu")
    return jt, js, pt, ps


def _ref_dense_noise(method, kn, emb):
    """The SR draw the reference's ``dense_update`` takes from ``kn``."""
    def u(k, table):
        return torch.from_numpy(_np(jq.sr_noise(k, table.codes.shape)))

    fold = jax.random.fold_in
    if method == "lpt":
        return u(kn, emb)
    if method == "alpt":
        return u(fold(kn, 1), emb)
    if method == "qr_lpt":
        return [u(fold(kn, g), t) for g, t in enumerate((emb.remainder, emb.quotient))]
    if method == "qr_alpt":
        return [u(fold(fold(kn, g), 1), t) for g, t in enumerate((emb.remainder, emb.quotient))]
    if method == "mixed":
        return [u(fold(kn, g), t) for g, t in enumerate(emb.subs)]
    return None


def _port_grads(ps, method, spec, g_emb, g_dense):
    """The reference's ``(g_emb, g_dense)`` pytrees as the port's layout."""
    pos = {id(p): i for i, p in enumerate(ps.dense.parameters())}
    dense = [None] * len(pos)
    for p, g in zip(tree_leaves(ps.dense.param_tree()), jax.tree.leaves(g_dense), strict=True):
        dense[pos[id(p)]] = torch.from_numpy(_np(g))
    like = methods.get(method).dense_params(ps.emb_state, spec)
    return tree_like(like, [torch.from_numpy(_np(g)) for g in jax.tree.leaves(g_emb)]), dense


def _state_leaves(pcfg, ps):
    got = interop.state_to_numpy(pcfg, ps)
    emb = got.get("emb_state")
    if emb is None:
        emb = {k: got[k] for k in ("codes", "step", "mu", "nu", "count")}
    out = {"emb": jax.tree.leaves(emb), "dense": jax.tree.leaves(got["dense_params"]),
           "dense_opt": jax.tree.leaves((got["dense_opt"]["mu"], got["dense_opt"]["nu"]))}
    if "emb_opt" in got:
        out["emb_opt"] = jax.tree.leaves((got["emb_opt"]["mu"], got["emb_opt"]["nu"]))
    return out


def _ref_leaves(js):
    out = {"emb": jax.tree.leaves(to_np(js.emb_state)),
           "dense": jax.tree.leaves(js.dense_params),
           "dense_opt": jax.tree.leaves((js.dense_opt.mu, js.dense_opt.nu))}
    if js.emb_opt is not None:
        out["emb_opt"] = jax.tree.leaves((js.emb_opt.mu, js.emb_opt.nu))
    return out


# -------------------------------------------------- (c) rung 2: apply_fn


@pytest.mark.parametrize("method,pad", [("alpt", True), ("lpt", True), ("qr_alpt", True),
                                        ("mixed", False), ("lsq", False), ("prune", False)])
def test_ctr_apply_fn_bitwise_from_the_reference_gradients(method, pad):
    jt, js, pt, ps = _ctr_pair(method, pad=pad)
    ids, labels = DATA.batch("train", 0, BATCH)
    _, kd, kn = jax.random.split(js.rng, 3)
    loss, (g_emb, g_dense) = jax.jit(jt.build_grad_fn())(js, jnp.asarray(ids),
                                                         jnp.asarray(labels), kd)
    rs = np.random.RandomState(1)
    g_step = None  # one Delta gradient on both sides (rung 2: no second forward)
    if method == "alpt":
        g_step = ((rs.randn(N_FEATURES) * 1e-3).astype(f32),)
    elif method == "qr_alpt":
        g_step = tuple((rs.randn(m) * 1e-3).astype(f32) for m in jhash.qr_rows(N_FEATURES, 2.0))
    jdelta = pdelta = None
    if g_step is not None:
        def jdelta(w_new, step_vec, dense, gscale):
            return jnp.asarray(g_step[0]) if len(g_step) == 1 else tuple(map(jnp.asarray, g_step))

        def pdelta(w_new, step_vec, dense, gscale):
            t = tuple(torch.from_numpy(g) for g in g_step)
            return t[0] if len(t) == 1 else t
    lr = jt._lr_at(js.step)
    jnew, jm = jax.jit(lambda s, loss, g: jt.build_apply_fn()(
        s, loss, g, lr=lr, rng=js.rng, kn=kn, delta_grad=jdelta, batch_rows=ids.size))(
        js, loss, (g_emb, g_dense))
    pnew, pm = pt.build_apply_fn()(
        ps, torch.from_numpy(_np(loss)), _port_grads(ps, method, pt.spec, g_emb, g_dense),
        lr=float(lr), noise=_ref_dense_noise(method, kn, js.emb_state), delta_grad=pdelta,
        batch_rows=ids.size)
    got, want = _state_leaves(pt.cfg, pnew), _ref_leaves(jnew)
    assert got.keys() == want.keys()
    for part in got:
        for a, b in zip(got[part], want[part], strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=part)
    assert pnew.step == 1 and float(pm["loss"]) == float(jm["loss"])


def test_lm_apply_fn_bitwise_from_the_reference_gradients():
    for method in ("alpt", "lpt", "fp"):
        jcfg, cfg, jt, pt, js, ps = _lm_pair(method, grad_clip=1e9)
        jb, pb = _lm_batch(cfg, 0)
        rng, kn = jax.random.split(js.rng)
        (loss, aux), grads = jax.jit(jlm.make_grad_fn(jcfg, jt))(js, jb)
        g_step = (np.random.RandomState(2).randn(cfg.vocab_size) * 1e-3).astype(f32)
        jdelta = (lambda *a: jnp.asarray(g_step)) if method == "alpt" else None
        pdelta = (lambda *a: torch.from_numpy(g_step)) if method == "alpt" else None
        lr = jlm.make_lr_fn(jt)(js.step)
        jnew, _ = jax.jit(lambda s, la, g: jlm.make_apply_fn(jcfg, jt)(
            s, la, g, lr=lr, rng=rng, kn=kn, delta_grad=jdelta, batch_rows=64))(
            js, (loss, aux), grads)
        g_emb, g_params = grads
        like = methods.get(method).dense_params(ps.table, lm_trainer.embedding_spec_of(cfg, pt))
        pgrads = (tree_like(like, [torch.from_numpy(_np(g)) for g in jax.tree.leaves(g_emb)]),
                  [torch.from_numpy(_np(g)) for g in jax.tree.leaves(g_params)])
        pnew, _ = lm_trainer.make_apply_fn(cfg, pt)(
            ps, (torch.from_numpy(_np(loss)), torch.from_numpy(_np(aux))), pgrads,
            lr=float(lr), noise=_ref_lm_noise(method, kn, js), delta_grad=pdelta,
            batch_rows=64)
        got = interop.lm_state_to_numpy(pnew)
        for a, b in zip(jax.tree.leaves((got["params"], got["opt"]["mu"], got["opt"]["nu"])),
                        jax.tree.leaves((jnew.params, jnew.opt.mu, jnew.opt.nu)), strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=method)
        for a, b in zip(jax.tree.leaves(got["table"]), jax.tree.leaves(to_np(jnew.table)),
                        strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=method)


# ------------------------------------------------ (d) rung 3: grad_fn, sync


@pytest.mark.parametrize("method", ["alpt", "qr_lpt", "lsq"])
def test_ctr_grad_fn_and_its_sync_against_the_reference(method):
    jt, js, pt, ps = _ctr_pair(method, pad=method == "alpt")
    _, kd, _ = jax.random.split(js.rng, 3)
    jgrad, pgrad = jax.jit(jt.build_grad_fn()), pt.build_grad_fn()
    ids, labels = DATA.batch("train", 0, BATCH)
    shards = [(ids[32 * i: 32 * (i + 1)], labels[32 * i: 32 * (i + 1)]) for i in range(2)]
    j_out = [jgrad(js, jnp.asarray(i), jnp.asarray(y), kd) for i, y in shards]
    p_out = [pgrad(ps, torch.from_numpy(i), torch.from_numpy(y), None) for i, y in shards]
    leaves_of = dpm.CTRGradLeaves(ps.dense)
    for (jl, jg), (pl, pg) in zip(j_out, p_out):
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
        for a, b in zip(leaves_of.flat(pg), jax.tree.leaves(jg), strict=True):
            b = _np(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-6 * np.abs(b).max() + 1e-30)
    # Synced at 8 bits with the reference's noise: within one sync step
    # (each rank's code may flip by one, so the mean of n ranks by one step).
    stacks = jax.tree.map(lambda *x: jnp.stack(x), *[g for _, g in j_out])
    jsynced = jax.jit(lambda g: jdp._combine_tree_stacked(
        g, jax.random.fold_in(jax.random.PRNGKey(SEED), 0), jdp.DPConfig(sync_bits=8)))(stacks)
    sync = dpm.GradSync(dpm.DPConfig(sync_bits=8), ref_sync_noise)
    psynced = sync.tree([list(x) for x in zip(*[leaves_of.flat(g) for _, g in p_out])], 0,
                        stacked=True)
    for a, b, stack in zip(psynced, jax.tree.leaves(jsynced), jax.tree.leaves(stacks),
                           strict=True):
        step = np.abs(_np(stack)).max() / 127.0
        assert np.abs(a.numpy() - _np(b)).max() <= step * 1.0001


# ------------------------------------------------------------ LM fixtures


def _lm_pair(method, *, bits=8, sync_bits=32, grad_clip=1.0):
    jcfg = dataclasses.replace(jconfigs.smoke_config("smollm-135m"), embedding_method=method,
                               embedding_bits=bits, n_layers=1)
    cfg = dataclasses.replace(configs.smoke_config("smollm-135m"), embedding_method=method,
                              embedding_bits=bits, n_layers=1)
    jt = jlm.LMTrainerConfig(lr=1e-3, dp_sync_bits=sync_bits, grad_clip=grad_clip)
    pt = lm_trainer.LMTrainerConfig(lr=1e-3, dp_sync_bits=sync_bits, grad_clip=grad_clip)
    js = jlm.init_state(jax.random.PRNGKey(1), jcfg, jt)
    tree = jax.tree.map(_np, js)
    table_opt = None
    if method == "fp":
        table = tree.table
        table_opt = {"step": tree.table_opt.step, "mu": tree.table_opt.mu,
                     "nu": tree.table_opt.nu}
    else:
        table = {"codes": _np(js.table.codes.data), "step": tree.table.step,
                 "mu": tree.table.mu, "nu": tree.table.nu, "count": tree.table.count}
    ps = interop.lm_state_from_numpy(
        cfg, pt, params=tree.params, table=table, table_opt=table_opt,
        opt={"step": tree.opt.step, "mu": tree.opt.mu, "nu": tree.opt.nu}, device="cpu")
    return jcfg, cfg, jt, pt, js, ps



def _lm_batch(cfg, i, batch=4, seq=16):
    data = LMTokenStream(cfg.vocab_size, seq, seed=17).batch(i, batch)
    return ({"tokens": jnp.asarray(data[:, :-1]), "labels": jnp.asarray(data[:, 1:])},
            {"tokens": torch.from_numpy(data[:, :-1]), "labels": torch.from_numpy(data[:, 1:])})



def _ref_lm_noise(method, kn, js):
    if method == "fp":
        return None
    key = kn if method == "lpt" else jax.random.fold_in(kn, 1)
    return torch.from_numpy(_np(jq.sr_noise(key, js.table.codes.shape)))




@pytest.mark.parametrize("method", ["fp", "lpt", "alpt"])
def test_lm_microbatched_step_against_the_reference(method):
    for bits in (32, 8):
        jcfg, cfg, jt, pt, js, ps = _lm_pair(method, sync_bits=bits)
        jstep = jdp.make_lm_microbatch_step(jcfg, jt, 2, jdp.DPConfig(sync_bits=bits))
        pstep = dpm.make_lm_microbatch_step(cfg, pt, 2, dpm.DPConfig(sync_bits=bits),
                                            sync_noise=ref_sync_noise)
        jl, pl = [], []
        for i in range(2):
            jb, pb = _lm_batch(cfg, i)
            noise = _ref_lm_noise(method, jax.random.split(js.rng)[1], js)
            js, jm = jstep(js, jb)
            ps, pm = pstep(ps, pb, noise)
            jl.append(float(jm["loss"]))
            pl.append(float(pm["loss"]))
        np.testing.assert_allclose(pl, jl, rtol=1e-6 if bits == 32 else 1e-5,
                                   err_msg=f"{method} {bits}")
        jtab = _np(jlm.table_fp_of(js, jcfg, jt))
        ptab = lm_trainer.table_fp_of(ps, cfg, pt).detach().numpy()
        if method != "fp":
            assert (jtab != ptab).mean() <= 1e-3
        np.testing.assert_allclose(ptab, jtab, rtol=0, atol=1e-5)
        assert ps.step == int(js.step) == 2


def test_grad_shapes_are_what_the_steps_sync():
    jt, js, pt, ps = _ctr_pair("alpt", pad=True)
    shapes = dpm.ctr_grad_shapes(pt, ps, BATCH, 6)
    _, grads = pt.build_grad_fn()(ps, *pt._batch(*DATA.batch("train", 0, BATCH)))
    assert shapes == [tuple(g.shape) for g in dpm.CTRGradLeaves(ps.dense).flat(grads)]
    ref = jdp.ctr_grad_shapes(jt, js, BATCH, 6)
    assert shapes == [tuple(s.shape) for s in jax.tree.leaves(ref)]
    jcfg, cfg, jt_, pt_, js_, ps_ = _lm_pair("lpt")
    _, pb = _lm_batch(cfg, 0)
    jb, _ = _lm_batch(cfg, 0)
    want = [tuple(s.shape) for s in jax.tree.leaves(jdp.lm_grad_shapes(jcfg, jt_, js_, jb))]
    assert dpm.lm_grad_shapes(cfg, pt_, ps_, pb) == want
