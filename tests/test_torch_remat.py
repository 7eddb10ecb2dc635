"""``remat`` (activation checkpointing per layer group) and deepseek-67b,
which sets it, against the JAX package at its smoke config, and the port's
remat on against off.

The reference wraps each group's period forward in ``jax.checkpoint``; the
port wraps it in ``torch.utils.checkpoint`` (non-reentrant), which keeps the
graph and recomputes its saved tensors by the same operations, so remat on
is bitwise remat off in the loss, every gradient and a whole train step.
The reference's ``lm_trainer.init_state`` builds the state, ``interop``
carries it across; the same token batches and, where a step rounds
stochastically, the reference's SR noise go through both, the reference
jitted.

Tolerances, each with the gap measured when it was set:
- ``loss_fn`` (rung 3): loss within rtol 1e-6 (measured 0), the table
  gradient within atol 2e-6 (measured 3.6e-7), each param gradient within
  5e-5 of its largest entry (measured 2.1e-6);
- one ALPT-8 step: loss, grad norm, Delta's gradient norm and mean Delta
  within rtol 1e-5 (measured 2.7e-7), params within atol 5e-5 (rung 3;
  measured 4.1e-6); codes and Delta bitwise (rung 2);
- the port's remat on against off: bitwise.
"""
import contextlib
import dataclasses
import functools
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
from repro.models import transformer as jtfm
from repro.training import lm_trainer as jlm
from repro_torch import configs, interop
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as tfm
from repro_torch.optim import tree_leaves, tree_like
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")
ARCH = "deepseek-67b"


@functools.lru_cache(maxsize=None)
def _pair(seed=1):
    """(ref cfg, port cfg, ref tcfg, port tcfg, ref state, port state)."""
    jcfg, cfg = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
    jt, pt = jlm.LMTrainerConfig(), lm_trainer.LMTrainerConfig()
    js = jlm.init_state(jax.random.PRNGKey(seed), jcfg, jt)
    tree = jax.tree.map(np.asarray, js)
    table = {"codes": np.asarray(js.table.codes.data), "step": tree.table.step,
             "mu": tree.table.mu, "nu": tree.table.nu, "count": tree.table.count}
    ps = interop.lm_state_from_numpy(
        cfg, pt, params=tree.params, table=table,
        opt={"step": tree.opt.step, "mu": tree.opt.mu, "nu": tree.opt.nu}, device="cpu")
    return jcfg, cfg, jt, pt, js, ps


def _batch(cfg, i, batch=2, seq=32):
    """The step-``i`` batch of ``cfg``'s input mode, as numpy: tokens and
    labels from the token stream, or (``embeds``) seeded normal frames and
    the labels modulo the vocabulary."""
    data = LMTokenStream(cfg.vocab_size, seq, seed=17).batch(i, batch)
    if cfg.input_mode == "embeds":
        frames = np.random.RandomState(i).normal(0, 1, (batch, seq, cfg.d_model))
        return {"embeds": frames.astype(np.float32), "labels": data[:, 1:] % cfg.vocab_size}
    return {"tokens": data[:, :-1], "labels": data[:, 1:]}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------- against the reference


def test_loss_fn_and_gradients_match_the_reference():
    """deepseek-67b-smoke's ``loss_fn`` (3 groups, each rematerialized on both
    sides) and its gradients w.r.t. every param and the dense table
    (rung 3)."""
    jcfg, cfg, jt, _, js, ps = _pair()
    assert jcfg.remat and cfg.remat
    batch = _batch(cfg, 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jspec = jlm.embedding_spec_of(jcfg, jt)
    jtab = jmethods.get(jspec.method).dense_table(js.table, jspec)
    (jl, _), (jgp, jgt) = jax.jit(jax.value_and_grad(
        lambda p, t: jtfm.loss_fn(p, t, jb, jcfg), argnums=(0, 1), has_aux=True))(js.params, jtab)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(ps.params)]
    tab = torch.from_numpy(np.array(jtab)).requires_grad_(True)
    loss, _ = tfm.loss_fn(tree_like(ps.params, leaves), tab, _torch(batch), cfg)
    g_tab, *g_params = torch.autograd.grad(loss, [tab, *leaves])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g_tab.numpy(), np.asarray(jgt), atol=2e-6, rtol=0)
    ref_leaves = jax.tree.leaves(jgp)
    assert len(ref_leaves) == len(g_params)
    for got, want in zip(g_params, ref_leaves):
        want = np.asarray(want)
        assert np.isfinite(want).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5 * np.abs(want).max(), rtol=0)


def test_alpt_train_step_matches_the_reference():
    """One ALPT-8 step of deepseek-67b-smoke (the Delta recompute remats too)
    from the reference's state with its SR noise: codes and Delta bitwise
    (rung 2); loss, gradient norms and params within tolerance (rung 3)."""
    jcfg, cfg, jt, pt, js, ps = _pair()
    batch = _batch(cfg, 1)
    kn = jax.random.split(js.rng)[1]
    js1, jm = jax.jit(jlm.make_train_step(jcfg, jt))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    noise = torch.from_numpy(np.array(jq.sr_noise(jax.random.fold_in(kn, 1),
                                                  tuple(js.table.codes.shape))))
    ps1, pm = lm_trainer.make_train_step(cfg, pt)(ps, _torch(batch), noise)
    np.testing.assert_array_equal(ps1.table.codes.data.numpy(), np.asarray(js1.table.codes.data))
    np.testing.assert_array_equal(ps1.table.step.numpy(), np.asarray(js1.table.step))
    for key in ("loss", "grad_norm", "step_grad_norm", "mean_step"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    for got, want in zip(tree_leaves(ps1.params), jax.tree.leaves(js1.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


# ------------------------------------------------------------- remat on == off


@pytest.mark.parametrize("arch", ["deepseek-67b", "hubert-xlarge", "jamba-v0.1-52b"])
def test_remat_on_equals_off_bitwise(arch):
    """The loss, the MoE aux and every gradient (params and table) with remat
    on and off, bitwise: the dense stack, the encoder, and Jamba's hybrid
    period of mamba, attention and MoE layers in one rematerialized
    group."""
    cfg = configs.smoke_config(arch)
    tcfg = lm_trainer.LMTrainerConfig()
    state = lm_trainer.init_state(cfg, tcfg, seed=2, device="cpu")
    batch = _torch(_batch(cfg, 0))
    out = {}
    for remat in (True, False):
        (loss, aux), (g_emb, g_params) = lm_trainer.make_grad_fn(
            dataclasses.replace(cfg, remat=remat), tcfg)(state, batch)
        out[remat] = [loss, aux, *tree_leaves(g_emb), *g_params]
    assert len(out[True]) == len(out[False])
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))
    assert (float(out[True][1]) > 0) == (cfg.moe is not None)


def test_train_steps_remat_on_equal_off_bitwise():
    """Two ALPT-8 steps of deepseek-67b-smoke with remat on and off from one
    seed: losses, every param, Adam moment, code, Delta and row-Adam slot
    bitwise."""
    runs = []
    for remat in (True, False):
        cfg = dataclasses.replace(configs.smoke_config(ARCH), remat=remat)
        tcfg = lm_trainer.LMTrainerConfig()
        state = lm_trainer.init_state(cfg, tcfg, seed=5, device="cpu")
        step = lm_trainer.make_train_step(cfg, tcfg)
        losses = []
        for i in range(2):
            state, m = step(state, _torch(_batch(cfg, i)))
            losses.append(float(m["loss"]))
        t = state.table
        runs.append((losses, [*tree_leaves(state.params), *state.opt.mu, *state.opt.nu,
                              t.codes.data, t.step, t.mu, t.nu]))
    (on_losses, on), (off_losses, off) = runs
    assert on_losses == off_losses and all(map(math.isfinite, on_losses))
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_donated_step_is_bitwise_the_functional_one():
    """``make_train_step(donate=True)``: two ALPT-8 steps of
    deepseek-67b-smoke bitwise the functional step's (losses, params, Adam
    moments, table), the params and moments stepped in the storage passed
    in; the guard, which rolls back to the old state, refuses donation."""
    cfg = configs.smoke_config(ARCH)
    tcfg = lm_trainer.LMTrainerConfig()
    runs = []
    for donate in (False, True):
        state = lm_trainer.init_state(cfg, tcfg, seed=6, device="cpu")
        ptrs = [t.data_ptr() for t in [*tree_leaves(state.params), *state.opt.mu, *state.opt.nu]]
        step = lm_trainer.make_train_step(cfg, tcfg, donate=donate)
        losses = []
        for i in range(2):
            state, m = step(state, _torch(_batch(cfg, i)))
            losses.append(float(m["loss"]))
        leaves = [*tree_leaves(state.params), *state.opt.mu, *state.opt.nu]
        assert ([t.data_ptr() for t in leaves] == ptrs) == donate
        t = state.table
        runs.append((losses, [*leaves, t.codes.data, t.step, t.mu, t.nu]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    with pytest.raises(ValueError, match="guard"):
        lm_trainer.make_train_step(cfg, dataclasses.replace(tcfg, guard=True), donate=True)


def test_remat_keeps_a_groups_inputs_not_its_activations():
    """Under grad mode, the tensors saved for the backward: with remat each
    group keeps its inputs, fewer bytes than the activations it keeps
    without (counted through ``saved_tensors_hooks``); outside grad mode
    remat changes nothing."""
    cfg = configs.smoke_config(ARCH)
    state = lm_trainer.init_state(cfg, seed=3, device="cpu", optimizer=False)
    table = lm_trainer.table_fp_of(state, cfg)
    batch = _torch(_batch(cfg, 0, seq=64))

    def saved_bytes(remat):
        c = dataclasses.replace(cfg, remat=remat)
        params = tree_like(state.params, [p.detach().requires_grad_(True)
                                          for p in tree_leaves(state.params)])
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            h, _ = tfm.backbone(params, table[batch["tokens"]], c,
                                tfm.default_positions(2, 64, c), train=True)
        return total[0], h

    (on, h_on), (off, h_off) = saved_bytes(True), saved_bytes(False)
    assert torch.equal(h_on, h_off)
    assert 0 < on < off / 2, (on, off)
    with torch.no_grad():
        a = tfm.loss_fn(state.params, table, batch, cfg)[0]
        b = tfm.loss_fn(state.params, table, batch, dataclasses.replace(cfg, remat=False))[0]
    assert torch.equal(a, b)


# ------------------------------------------------------------- CLIs


def test_train_and_serve_clis_take_deepseek_67b(capsys):
    """``train lm --arch deepseek-67b --smoke --device cpu`` trains with remat
    (finite losses, no launches on the CPU, no fallbacks); ``serve lm``
    serves every request (serving runs no backward: remat has nothing to
    do)."""
    assert train_cli.main(["lm", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                           "--batch", "2", "--seq", "32", "--log-every", "0"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["arch"] == "deepseek-67b-smoke" and len(r["losses"]) == 2
    assert all(math.isfinite(x) for x in r["losses"])
    assert r["kernel_launches"] == {} and r["fallbacks"] == []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve_cli.main(["lm", "--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                               "3", "--gen", "4", "--prompt-len", "8"]) == 0
    m = json.loads(out.getvalue().strip().splitlines()[-1])
    assert m["requests_completed"] == 3 and m["tokens_generated"] == 12
