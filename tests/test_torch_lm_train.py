"""The port's LM training slice against the JAX package, at the smoke configs.

The reference's ``lm_trainer.init_state`` builds params, their Adam state and
the vocab table; ``interop.lm_state_from_numpy`` carries them into the port;
the same token batches (``LMTokenStream``, byte-equal in both packages) and,
where a step rounds stochastically, the reference's own SR noise go through
both.  The reference runs jitted, as it trains.

Tolerances, each with the gap measured when it was set:
- training attention: outputs and q/k/v gradients within atol 5e-6 (measured
  <= 7.2e-7: exp and sums over blocks in another order);
- ``loss_fn``: loss within rtol 1e-6 (measured 1.4e-7), the table gradient
  within atol 2e-6 on entries up to ~0.14 (measured 1.5e-7), each param
  gradient within 5e-5 of its largest entry (measured 1.8e-6): fp32 matmuls
  summed in another order through 2-3 layers;
- one train step: loss and grad norm within rtol 1e-6, params within atol
  5e-5 (measured 1.5e-5 after one AdamW step at lr 3e-4);
- 5 steps with the reference's noise: losses within rtol 1e-5 (measured
  1.4e-7).
"""
import contextlib
import dataclasses
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import methods as jmethods
from repro.core import quant as jq
from repro.data.lm_synth import LMTokenStream as JLMTokenStream
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.training import lm_trainer as jlm
from repro_torch import configs, interop
from repro_torch.core.lpt import LPTTable
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.optim import tree_leaves, tree_like
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")
f32 = np.float32
ARCHS = ["smollm-135m", "qwen3-1.7b", "h2o-danube-1.8b"]


def _pair(arch, method="alpt", bits=8, seed=1):
    """(ref cfg, port cfg, ref tcfg, port tcfg, ref state, port state)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), embedding_method=method,
                               embedding_bits=bits)
    cfg = dataclasses.replace(configs.smoke_config(arch), embedding_method=method,
                              embedding_bits=bits)
    jt, pt = jlm.LMTrainerConfig(), lm_trainer.LMTrainerConfig()
    js = jlm.init_state(jax.random.PRNGKey(seed), jcfg, jt)
    tree = jax.tree.map(np.asarray, js)
    table_opt = None
    if method == "fp":
        table = tree.table
        table_opt = {"step": tree.table_opt.step, "mu": tree.table_opt.mu,
                     "nu": tree.table_opt.nu}
    else:
        table = {"codes": np.asarray(js.table.codes.data), "step": tree.table.step,
                 "mu": tree.table.mu, "nu": tree.table.nu, "count": tree.table.count}
    ps = interop.lm_state_from_numpy(
        cfg, pt, params=tree.params, table=table, table_opt=table_opt,
        opt={"step": tree.opt.step, "mu": tree.opt.mu, "nu": tree.opt.nu}, device="cpu")
    return jcfg, cfg, jt, pt, js, ps


def _batches(vocab, i, batch=2, seq=64):
    data = LMTokenStream(vocab, seq, seed=17).batch(i, batch)
    return ({"tokens": jnp.asarray(data[:, :-1]), "labels": jnp.asarray(data[:, 1:])},
            {"tokens": torch.from_numpy(data[:, :-1]), "labels": torch.from_numpy(data[:, 1:])})


def _ref_noise(method, kn, shape):
    """The SR draw the reference's dense update takes for ``method``."""
    if method == "lpt":
        return torch.from_numpy(np.array(jq.sr_noise(kn, shape)))
    if method == "alpt":
        return torch.from_numpy(np.array(jq.sr_noise(jax.random.fold_in(kn, 1), shape)))
    return None


@pytest.mark.parametrize("seed,vocab,seq", [(17, 512, 64), (0, 49152, 33), (5, 97, 8)])
def test_lm_token_stream_byte_equal(seed, vocab, seq):
    ref, port = JLMTokenStream(vocab, seq, seed=seed), LMTokenStream(vocab, seq, seed=seed)
    for index in (0, 1, 7, 1000):
        a, b = ref.batch(index, 3), port.batch(index, 3)
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()
    for (ra, rb), (pa, pb) in zip(ref.batches(2, 3, start=4), port.batches(2, 3, start=4)):
        np.testing.assert_array_equal(ra, pa)
        np.testing.assert_array_equal(rb, pb)


@pytest.mark.parametrize("b,t,h,kh,d,causal,window,qb,kb", [
    (2, 40, 4, 2, 16, True, None, 16, 16),  # causal GQA, T not a multiple of the blocks
    (1, 50, 4, 4, 8, True, 12, 16, 32),  # a sliding window (Danube), MHA
    (2, 33, 6, 2, 16, False, None, 16, 8),  # non-causal
    (1, 64, 3, 1, 16, True, None, 32, 32),  # SmolLM's 3:1 GQA, whole blocks
])
def test_training_attention_matches_the_reference_vjp(b, t, h, kh, d, causal, window, qb, kb):
    """Forward and the gradients w.r.t. q, k, v of ``flash_attention_train``
    against ``jax.value_and_grad`` through the reference's custom-VJP
    ``layers.flash_attention``; it never reaches the forward-only kernel."""
    rs = np.random.RandomState(t)
    q, ct = (rs.randn(b, t, h, d).astype(f32) for _ in range(2))
    k, v = (rs.randn(b, t, kh, d).astype(f32) for _ in range(2))

    def jloss(q, k, v):
        o = jlayers.flash_attention(q, k, v, causal=causal, window=window, q_block=qb,
                                    k_block=kb)
        return jnp.sum(o * ct), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    ops.reset_kernel_calls()
    o = L.flash_attention_train(tq, tk, tv, causal=causal, window=window, q_block=qb,
                                k_block=kb)
    (o * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=5e-6, rtol=0)
    for got, want in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=5e-6, rtol=0)
    assert ops.kernel_calls() == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_gradients_match_the_reference(arch):
    """``loss_fn`` and its gradients w.r.t. every param and the dense table,
    from the reference's params and de-quantized ALPT table."""
    jcfg, cfg, jt, _, js, ps = _pair(arch)
    jb, pb = _batches(cfg.vocab_size, 0)
    jspec = jlm.embedding_spec_of(jcfg, jt)
    jtab = jmethods.get(jspec.method).dense_table(js.table, jspec)
    (jl, _), (jgp, jgt) = jax.jit(jax.value_and_grad(
        lambda p, t: jtfm.loss_fn(p, t, jb, jcfg), argnums=(0, 1), has_aux=True))(js.params, jtab)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(ps.params)]
    tab = torch.from_numpy(np.array(jtab)).requires_grad_(True)
    loss, aux = tfm.loss_fn(tree_like(ps.params, leaves), tab, pb, cfg)
    g_tab, *g_params = torch.autograd.grad(loss, [tab, *leaves])
    assert float(aux) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g_tab.numpy(), np.asarray(jgt), atol=2e-6, rtol=0)
    ref_leaves = jax.tree.leaves(jgp)
    assert len(ref_leaves) == len(g_params)
    for got, want in zip(g_params, ref_leaves):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("alpt", 4), ("lpt", 8), ("lpt", 4),
                                         ("fp", 8)])
def test_one_train_step_matches_the_reference(method, bits):
    """One ``make_train_step`` step from the reference's state, with its SR
    noise: loss, grad norm and params within tolerance; the table's codes
    and Delta equal (the row-Adam slots follow the table gradient, held in
    :func:`test_lpt_apply_from_reference_gradients_is_bitwise`)."""
    jcfg, cfg, jt, pt, js, ps = _pair("smollm-135m", method, bits)
    jb, pb = _batches(cfg.vocab_size, 0)
    kn = jax.random.split(js.rng)[1]
    shape = tuple(js.table.shape if method == "fp" else js.table.codes.shape)
    js1, jm = jax.jit(jlm.make_train_step(jcfg, jt))(js, jb)
    ps1, pm = lm_trainer.make_train_step(cfg, pt)(ps, pb, _ref_noise(method, kn, shape))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    for got, want in zip(tree_leaves(ps1.params), jax.tree.leaves(js1.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    assert ps1.step == int(js1.step) == 1
    if method == "fp":
        np.testing.assert_allclose(ps1.table.numpy(), np.asarray(js1.table), atol=5e-5, rtol=0)
    else:
        np.testing.assert_array_equal(ps1.table.codes.data.numpy(), np.asarray(js1.table.codes.data))
        np.testing.assert_array_equal(ps1.table.step.numpy(), np.asarray(js1.table.step))
        assert ps1.table.count == int(js1.table.count) == 1
    if method == "alpt":
        for key in ("step_grad_norm", "mean_step"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_lpt_apply_from_reference_gradients_is_bitwise(bits):
    """Rung 2 through the trainer: the port's ``make_apply_fn`` given the
    reference's gradients (table and params) and noise leaves the table —
    codes, Delta, row-Adam mu / nu, count — bit for bit the reference's.
    Danube's head is untied, so rows no token of the batch reads get a zero
    gradient and must keep their codes (a tied head touches every row)."""
    jcfg, cfg, jt, pt, js, ps = _pair("h2o-danube-1.8b", "lpt", bits)
    jb, _ = _batches(cfg.vocab_size, 1)
    (jl, jaux), (jg_tab, jg_params) = jax.jit(jlm.make_grad_fn(jcfg, jt))(js, jb)
    rng, kn = jax.random.split(js.rng)
    lr = f32(3e-4)
    japply = jax.jit(lambda s, la, g, kn: jlm.make_apply_fn(jcfg, jt)(
        s, la, g, lr=lr, rng=rng, kn=kn, batch_rows=int(jb["labels"].size)))
    js1, _ = japply(js, (jl, jaux), (jg_tab, jg_params), kn)
    grads = (torch.from_numpy(np.array(jg_tab)),
             [torch.from_numpy(np.array(g)) for g in jax.tree.leaves(jg_params)])
    ps1, _ = lm_trainer.make_apply_fn(cfg, pt)(
        ps, (torch.tensor(float(jl)), torch.tensor(float(jaux))), grads, lr=float(lr),
        noise=_ref_noise("lpt", kn, tuple(js.table.codes.shape)),
        batch_rows=int(jb["labels"].size))
    np.testing.assert_array_equal(ps1.table.codes.data.numpy(), np.asarray(js1.table.codes.data))
    for name in ("step", "mu", "nu"):
        np.testing.assert_array_equal(getattr(ps1.table, name).numpy(),
                                      np.asarray(getattr(js1.table, name)), err_msg=name)
    untouched = ~(np.asarray(jg_tab) != 0).any(-1)
    assert untouched.sum() > 100  # a batch of 128 tokens touches few of 512 rows
    np.testing.assert_array_equal(ps1.table.codes.data.numpy()[untouched],
                                  ps.table.codes.data.numpy()[untouched])
    for got, want in zip(tree_leaves(ps1.params), jax.tree.leaves(js1.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["fp", "lpt", "alpt"])
def test_five_steps_track_the_reference(method):
    """Five steps with the reference's noise injected: the losses within rtol
    1e-5 of the jitted reference's, and the table still its bytes."""
    jcfg, cfg, jt, pt, js, ps = _pair("smollm-135m", method, 8)
    jstep, pstep = jax.jit(jlm.make_train_step(jcfg, jt)), lm_trainer.make_train_step(cfg, pt)
    shape = tuple(js.table.shape if method == "fp" else js.table.codes.shape)
    jl, pl = [], []
    for i in range(5):
        jb, pb = _batches(cfg.vocab_size, i)
        noise = _ref_noise(method, jax.random.split(js.rng)[1], shape)
        js, jm = jstep(js, jb)
        ps, pm = pstep(ps, pb, noise)
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    if method != "fp":
        agree = (ps.table.codes.data.numpy() == np.asarray(js.table.codes.data)).mean()
        assert agree >= 0.999, agree


def test_lm_state_round_trips_through_numpy():
    for method in ("alpt", "fp"):
        _, cfg, _, pt, _, ps = _pair("h2o-danube-1.8b", method, 4)
        tree = interop.lm_state_to_numpy(ps)
        back = interop.lm_state_from_numpy(cfg, pt, **tree, device="cpu")
        again = interop.lm_state_to_numpy(back)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(again)):
            np.testing.assert_array_equal(a, b)
        assert isinstance(back.table, LPTTable) == (method != "fp")


def test_trainer_refuses_what_later_slices_bring():
    """The reference's alpt_every setting is not a field of the port's
    config (nothing reads it; its DP sync width, prune schedule,
    pad_to_tiles and guard are, since their slices are ported); remat, the
    last feature of the reference's configs to be ported, is taken: a step
    with it is bitwise the step without."""
    with pytest.raises(TypeError, match="alpt_every"):
        lm_trainer.LMTrainerConfig(alpt_every=2)
    assert lm_trainer.LMTrainerConfig(guard=True).guard
    assert lm_trainer.LMTrainerConfig(dp_sync_bits=8).dp_sync_bits == 8
    assert lm_trainer.LMTrainerConfig(pad_to_tiles=True).pad_to_tiles
    cfg = configs.smoke_config("smollm-135m")
    lm_trainer.make_train_step(dataclasses.replace(cfg, embedding_method="prune"),
                               lm_trainer.LMTrainerConfig())
    tcfg = lm_trainer.LMTrainerConfig()
    full = torch.from_numpy(LMTokenStream(cfg.vocab_size, 32, seed=17).batch(0, 2))
    batch = {"tokens": full[:, :-1], "labels": full[:, 1:]}
    runs = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        state, m = lm_trainer.make_train_step(c, tcfg)(
            lm_trainer.init_state(c, tcfg, seed=1, device="cpu"), batch)
        runs.append([m["loss"], *tree_leaves(state.params), state.table.codes.data])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_train_cli_lm_smoke_on_cpu():
    """``launch.train lm --smoke --device cpu``: its JSON line reports finite,
    falling losses, no kernel launches (CPU tensors take the plain versions),
    no fallbacks, and the table's training memory (codes + Delta + row Adam)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(["lm", "--arch", "smollm-135m", "--smoke", "--device", "cpu",
                             "--steps", "6", "--batch", "4", "--seq", "64", "--lr", "3e-3",
                             "--log-every", "0"])
    assert rc == 0
    r = json.loads(out.getvalue().strip().splitlines()[-1])
    assert r["method"] == "alpt" and r["bits"] == 8 and len(r["losses"]) == 6
    assert all(math.isfinite(x) for x in r["losses"]) and r["losses"][-1] < r["losses"][0]
    assert r["kernel_launches"] == {} and r["fallbacks"] == []
    cfg = configs.smoke_config("smollm-135m")
    n, d = cfg.vocab_size, cfg.d_model
    assert r["training_bytes"] == n * d + 4 * n + 2 * 4 * n * d
    assert r["embedding_bytes"] == n * d + 4 * n


def test_eval_step_reads_the_eval_table():
    _, cfg, _, pt, _, ps = _pair("smollm-135m", "lpt", 4)
    _, pb = _batches(cfg.vocab_size, 2)
    got = lm_trainer.make_eval_step(cfg, pt)(ps, pb)
    table = lm_trainer.table_fp_of(ps, cfg, pt)
    assert table.shape == (cfg.vocab_size, cfg.d_model)
    want, _ = tfm.loss_fn(ps.params, table, pb, cfg)
    assert float(got["loss"]) == float(want) and float(got["aux_loss"]) == 0.0


def test_clone_state_replays_the_same_steps():
    """``clone_state`` copies every tensor and the generator: stepping the
    original leaves the copy as it was, and the copy replays the same step
    (noise drawn from its own generator) bit for bit."""
    _, cfg, _, pt, _, ps = _pair("smollm-135m", "lpt", 4)
    copy = lm_trainer.clone_state(ps)
    _, pb = _batches(cfg.vocab_size, 3)
    step = lm_trainer.make_train_step(cfg, pt)
    a, ma = step(ps, pb)
    assert torch.equal(copy.table.codes.data, ps.table.codes.data)  # dense_apply is not in place
    b, mb = step(copy, pb)
    assert float(ma["loss"]) == float(mb["loss"])
    assert torch.equal(a.table.codes.data, b.table.codes.data)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
