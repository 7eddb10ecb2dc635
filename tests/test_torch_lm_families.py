"""The SSM and MoE LM families (mamba2-370m, deepseek-moe-16b, mixtral-8x7b,
jamba-v0.1-52b) and the VLM (qwen2-vl-7b: the layout, ``loss_fn`` on a mixed
batch, the engine on its text path) as a whole, against the JAX package, at
their smoke configs; the LM trainer's prune refresh and ``pad_to_tiles``.
The VLM's own tests are in tests/test_torch_vlm.py.

The reference's ``lm_trainer.init_state`` builds params and the vocab table;
``interop`` carries them into the port; the same token batches
(``LMTokenStream``, byte-equal in both packages), prompts made from a seed
with numpy and, where a step rounds stochastically, the reference's own SR
noise go through both.  The reference runs jitted, its engine as it serves.

Tolerances, each with the gap measured when it was set:
- ``loss_fn``: loss and aux loss within rtol 1e-6 (measured 1.4e-7 and
  9.2e-8), the table gradient within atol 2e-6 on entries up to ~0.2
  (measured 8.5e-7), each param gradient within 5e-5 of its largest entry
  (measured 1.3e-5: jamba's SSD and MoE through 8 layers);
- serving: the engines held teacher-forced, logits within atol 5e-5, rtol
  1e-5 (measured 7.7e-6 absolute), the prefill caches (KV rings, conv
  windows, SSD states) within atol 5e-5 (measured 5.7e-6), the greedy
  tokens equal up to the first step whose top-1/top-2 margin is within 10x
  that tolerance (tests/test_torch_lm_serving.py's rule);
- one train step: loss, aux and grad norm within rtol 1e-5 (measured
  1.7e-7), params within atol 5e-5 (measured 4.1e-6); the LPT write-back
  from the reference's gradients and noise bitwise (rung 2); ALPT's whole
  step (rung 3): its codes at least 99.9% equal, Delta within rtol 1e-5
  (measured equal), its step-gradient norm within rtol 1e-4 (measured
  3.0e-7);
- prune: four wrapped steps' losses within rtol 1e-5 (measured 1.4e-7).
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import methods as jmethods
from repro.checkpoint.manager import embedding_manifest as jembedding_manifest
from repro.core import pruning as jpruning
from repro.core import quant as jq
from repro.models import transformer as jtfm
from repro.serving.lm import LMEngine as JEngine
from repro.serving.lm import LMRequest as JRequest
from repro.training import lm_trainer as jlm
from repro_torch import configs, interop, methods
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.pruning import PruneConfig
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as tfm
from repro_torch.optim import tree_leaves, tree_like
from repro_torch.serving.lm import LMEngine, LMRequest
from repro_torch.training import data_parallel as dpm
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ["mamba2-370m", "deepseek-moe-16b", "mixtral-8x7b", "jamba-v0.1-52b", "qwen2-vl-7b"]
ATOL, RTOL = 5e-5, 1e-5
MAX_LEN = 24
# (prompt length, max_new), two prompt lengths (each one reference trace):
# staggered budgets free and refill slots at different steps; a budget of 1
# finishes at prefill.  Every length is at most one SSD chunk (32).
SHAPES = [(12, 6), (8, 3), (12, 5), (8, 1), (12, 4)]


@functools.lru_cache(maxsize=None)
def _pair(arch, method="alpt", bits=8, seed=1):
    """(ref cfg, port cfg, ref tcfg, port tcfg, ref state, port state)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), embedding_method=method,
                               embedding_bits=bits)
    cfg = dataclasses.replace(configs.smoke_config(arch), embedding_method=method,
                              embedding_bits=bits)
    jt, pt = jlm.LMTrainerConfig(), lm_trainer.LMTrainerConfig()
    js = jlm.init_state(jax.random.PRNGKey(seed), jcfg, jt)
    tree = jax.tree.map(np.asarray, js)
    table = {"codes": np.asarray(js.table.codes.data), "step": tree.table.step,
             "mu": tree.table.mu, "nu": tree.table.nu, "count": tree.table.count}
    ps = interop.lm_state_from_numpy(
        cfg, pt, params=tree.params, table=table,
        opt={"step": tree.opt.step, "mu": tree.opt.mu, "nu": tree.opt.nu}, device="cpu")
    return jcfg, cfg, jt, pt, js, ps


def _batches(vocab, i, batch=2, seq=32, cfg=None):
    """The step-``i`` batch, (reference's, port's); a mixed-input ``cfg``'s
    also carries a seeded normal visual prefix (default positions)."""
    data = LMTokenStream(vocab, seq, seed=17).batch(i, batch)
    out = {"tokens": data[:, :-1], "labels": data[:, 1:]}
    if cfg is not None and cfg.input_mode == "mixed":
        out["prefix_embeds"] = np.random.RandomState(i).normal(
            0, 1, (batch, cfg.visual_prefix, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _ref_noise(method, kn, shape):
    """The SR draw the reference's dense update takes for ``method``."""
    if method == "lpt":
        return torch.from_numpy(np.array(jq.sr_noise(kn, shape)))
    return torch.from_numpy(np.array(jq.sr_noise(jax.random.fold_in(kn, 1), shape)))


def _fields(cfg):
    """A config's fields, nested configs as dicts (the packages' dataclasses
    are different classes)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return out


# ------------------------------------------------------------- registry


def test_registry_and_configs_match_the_reference():
    for arch in ARCHS:
        assert arch in configs.ARCHS
        mod, jmod = configs.get_arch(arch), jconfigs.get_arch(arch)
        assert mod.SKIP_SHAPES == jmod.SKIP_SHAPES
        for make in ("full_config", "smoke_config"):
            got, want = _fields(getattr(mod, make)()), _fields(getattr(jmod, make)())
            for f in ("dtype", "param_dtype"):
                got.pop(f), want.pop(f)
            assert got == want, (arch, make)
    full = configs.full_config("deepseek-moe-16b", n_layers=2)
    assert full.n_groups == 2 and full.moe.n_experts == 64 and full.moe.top_k == 6
    assert configs.full_config("mamba2-370m").ssm.n_heads == 32


@pytest.mark.parametrize("override,what,refused", [
    (dict(mrope_sections=(4, 2, 2)), "M-RoPE", False), (dict(input_mode="embeds"), "embeds", False),
    (dict(input_mode="mixed", visual_prefix=4), "mixed", False),
    (dict(mlp_type="gelu"), "gelu", False), (dict(remat=True), "remat", False),
    (dict(input_mode="frames"), "input_mode", True), (dict(mlp_type="relu"), "mlp_type", True)])
def test_check_supported_names_only_what_is_unported(override, what, refused):
    """Every feature of the reference's configs is taken (M-RoPE and the
    mixed mode with the VLM slice; the embeds mode, the gelu MLP and remat
    with the encoder and remat slice) and its params drawn in the
    reference's layout (the gelu MLP's ``w_in`` / ``b_in`` / ``w_out`` /
    ``b_out``); only a malformed config is refused, by name."""
    for arch in ARCHS + ["smollm-135m"]:
        tfm.check_supported(configs.smoke_config(arch))
    cfg = dataclasses.replace(configs.smoke_config("jamba-v0.1-52b"), **override)
    if refused:
        with pytest.raises(ValueError, match=what):
            tfm.init_params(torch.Generator().manual_seed(0), cfg)
        return
    tfm.check_supported(cfg)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    assert set(params) == {"blocks", "final_norm", "head"}
    jcfg = dataclasses.replace(jconfigs.smoke_config("jamba-v0.1-52b"), **override)
    want = jax.eval_shape(functools.partial(jtfm.init_params, cfg=jcfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert [tuple(t.shape) for t in tree_leaves(params)] == [a.shape for a in jax.tree.leaves(want)]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The reference's tree (a pure-mamba block has no ``norm2``; MoE blocks
    ``moe`` with ``shared`` where configured), leaf for leaf and shape for
    shape, in the reference's flatten order."""
    cfg, jcfg = configs.smoke_config(arch), jconfigs.smoke_config(arch)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    want = jax.eval_shape(functools.partial(jtfm.init_params, cfg=jcfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == jax.tree.map(
        lambda a: tuple(a.shape), want)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(t.shape) for t in tree_leaves(params)] == [a.shape for _, a in flat]
    assert tfm.param_count(params) == sum(a.size for _, a in flat)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), want)
    bad = dict(zeros, blocks=[{"norm1": np.zeros((cfg.n_groups, 4), np.float32)}] * cfg.period)
    with pytest.raises(ValueError, match="block position 0"):
        tfm.params_from_numpy(cfg, bad, device="cpu")


# ------------------------------------------------------------- forward / loss


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_gradients_match_the_reference(arch):
    """``loss_fn`` (CE + the MoE aux summed over groups) and its gradients
    w.r.t. every param and the dense table."""
    jcfg, cfg, jt, _, js, ps = _pair(arch)
    jb, pb = _batches(cfg.vocab_size, 0, cfg=cfg)
    jspec = jlm.embedding_spec_of(jcfg, jt)
    jtab = jmethods.get(jspec.method).dense_table(js.table, jspec)
    (jl, jaux), (jgp, jgt) = jax.jit(jax.value_and_grad(
        lambda p, t: jtfm.loss_fn(p, t, jb, jcfg), argnums=(0, 1), has_aux=True))(js.params, jtab)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(ps.params)]
    tab = torch.from_numpy(np.array(jtab)).requires_grad_(True)
    loss, aux = tfm.loss_fn(tree_like(ps.params, leaves), tab, pb, cfg)
    g_tab, *g_params = torch.autograd.grad(loss, [tab, *leaves])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    assert (float(jaux) > 0) == (cfg.moe is not None)
    np.testing.assert_allclose(g_tab.numpy(), np.asarray(jgt), atol=2e-6, rtol=0)
    ref_leaves = jax.tree.leaves(jgp)
    assert len(ref_leaves) == len(g_params)
    for got, want in zip(g_params, ref_leaves):
        want = np.asarray(want)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5 * np.abs(want).max(), rtol=0)


def _forced(prefill_fn, decode_fn, prompt, tokens):
    """(logits [len(tokens), V], the prefill cache) with the model fed
    ``prompt + tokens[:-1]``."""
    logits, cache = prefill_fn(prompt[None, :])
    first = jax.tree.map(np.array, cache)
    out = [np.asarray(logits)[0]]
    for i, tok in enumerate(tokens[:-1]):
        logits, cache = decode_fn(np.array([tok], np.int32), cache, len(prompt) + i)
        out.append(np.asarray(logits)[0])
    return np.stack(out), first


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_reference_engine(arch):
    """The port's ``LMEngine`` (slot batch 2, refills) against the
    reference's on the same params and int8 table: teacher-forced logits
    through ``prefill`` / ``decode_step`` and the prefill caches (KV rings,
    conv windows and SSD states) within tolerance, greedy tokens equal as
    the module says; the requests in reverse order give the same tokens."""
    jcfg, cfg, jt, pt, js, ps = _pair(arch)
    jengine = JEngine.from_state(js, jcfg, jt, batch=2, max_len=MAX_LEN)
    engine = LMEngine.from_state(ps, cfg, pt, batch=2, max_len=MAX_LEN)
    rng = np.random.RandomState(11)
    reqs = [(rng.randint(0, cfg.vocab_size, n).astype(np.int32), g) for n, g in SHAPES]
    for i, (prompt, n) in enumerate(reqs):
        engine.submit(LMRequest(prompt=prompt, max_new=n, rid=i))
        jengine.submit(JRequest(prompt=prompt, max_new=n, rid=i))
    done, jdone = engine.run(), jengine.run()
    assert sorted(done) == sorted(jdone) == list(range(len(reqs)))

    jpre = jax.jit(functools.partial(jtfm.prefill, cfg=jcfg, max_len=MAX_LEN))
    jdec = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))
    compared = 0
    for i, (prompt, n) in enumerate(reqs):
        tokens = done[i]
        assert len(tokens) == len(jdone[i]) == n
        want, jcache = _forced(lambda p: jpre(js.params, jengine.table, jnp.asarray(p)),
                               lambda t, c, cl: jdec(js.params, jengine.table, jnp.asarray(t), c,
                                                     jnp.asarray(cl, jnp.int32)),
                               prompt, tokens)
        got, cache = _forced(
            lambda p: tfm.prefill(ps.params, engine.table, torch.from_numpy(p), cfg, MAX_LEN),
            lambda t, c, cl: tfm.decode_step(ps.params, engine.table, torch.from_numpy(t), c, cl,
                                             cfg),
            prompt, tokens)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        assert len(cache) == len(jcache) == cfg.period
        for c, jc in zip(cache, jcache):
            assert sorted(c) == sorted(jc)
            for key in c:
                np.testing.assert_allclose(c[key], jc[key], atol=ATOL, rtol=0)
        for step, (tok, jtok) in enumerate(zip(tokens, jdone[i])):
            if tok != jtok:
                top2 = np.sort(want[step])[-2:]
                assert top2[1] - top2[0] <= 10 * ATOL, (i, step, top2)
                break
            compared += 1
    assert compared > sum(n for _, n in reqs) // 2
    again = LMEngine.from_state(ps, cfg, pt, batch=2, max_len=MAX_LEN)
    for i in reversed(range(len(reqs))):
        again.submit(LMRequest(prompt=reqs[i][0], max_new=reqs[i][1], rid=i))
    assert again.run() == done


def test_engine_refuses_prompts_an_ssm_cannot_prefill():
    """Exact-length prefill: a mamba prompt longer than a chunk must be a
    multiple of it, and at least the conv window; attention stacks take any."""
    for arch, bad in (("mamba2-370m", (40, 2)), ("jamba-v0.1-52b", (33,))):
        cfg = configs.smoke_config(arch)
        engine = LMEngine.from_state(lm_trainer.init_state(cfg, device="cpu"), cfg, batch=1,
                                     max_len=80)
        for t in bad:
            with pytest.raises(ValueError, match="must divide chunk|conv window"):
                engine.submit(LMRequest(prompt=np.zeros(t, np.int32), max_new=2))
        engine.submit(LMRequest(prompt=np.zeros(64, np.int32), max_new=2, rid=0))
        assert len(engine.run()[0]) == 2
        with pytest.raises(ValueError, match="lens"):
            tfm.prefill(engine.params, engine.table, torch.zeros(2, 8, dtype=torch.int32), cfg,
                        16, lens=torch.tensor([8, 5]))


# ------------------------------------------------------------- training


@pytest.mark.parametrize("arch,method", [("mamba2-370m", "alpt"), ("mamba2-370m", "lpt"),
                                         ("deepseek-moe-16b", "alpt"),
                                         ("deepseek-moe-16b", "lpt")])
def test_train_step_matches_the_reference(arch, method):
    """One step from the reference's state with its SR noise: loss, aux,
    grad norm and params within tolerance.  LPT (rung 2): the port's
    ``make_apply_fn`` given the reference's gradients and noise leaves the
    table (codes, Delta, row-Adam mu / nu) bitwise the reference's.  ALPT
    (rung 3): the whole step's codes at least 99.9% equal, Delta close."""
    jcfg, cfg, jt, pt, js, ps = _pair(arch, method)
    jb, pb = _batches(cfg.vocab_size, 1)
    kn = jax.random.split(js.rng)[1]
    shape = tuple(js.table.codes.shape)
    noise = _ref_noise(method, kn, shape)
    if method == "lpt":
        (jl, jaux), (jg_tab, jg_params) = jax.jit(jlm.make_grad_fn(jcfg, jt))(js, jb)
        lr = np.float32(3e-4)
        js1, jm = jax.jit(lambda s, la, g, kn: jlm.make_apply_fn(jcfg, jt)(
            s, la, g, lr=lr, rng=kn, kn=kn, batch_rows=int(jb["labels"].size)))(
                js, (jl, jaux), (jg_tab, jg_params), kn)
        grads = (torch.from_numpy(np.array(jg_tab)),
                 [torch.from_numpy(np.array(g)) for g in jax.tree.leaves(jg_params)])
        ps1, pm = lm_trainer.make_apply_fn(cfg, pt)(
            ps, (torch.tensor(float(jl)), torch.tensor(float(jaux))), grads, lr=float(lr),
            noise=noise, batch_rows=int(jb["labels"].size))
        for name in ("step", "mu", "nu"):
            np.testing.assert_array_equal(getattr(ps1.table, name).numpy(),
                                          np.asarray(getattr(js1.table, name)), err_msg=name)
        np.testing.assert_array_equal(ps1.table.codes.data.numpy(),
                                      np.asarray(js1.table.codes.data))
        # The port's own backward: loss and its gradients within tolerance.
        (loss, aux), _ = lm_trainer.make_grad_fn(cfg, pt)(ps, pb)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    else:
        js1, jm = jax.jit(jlm.make_train_step(jcfg, jt))(js, jb)
        ps1, pm = lm_trainer.make_train_step(cfg, pt)(ps, pb, noise)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["aux_loss"]), float(jm["aux_loss"]), rtol=1e-5)
        agree = (ps1.table.codes.data.numpy() == np.asarray(js1.table.codes.data)).mean()
        assert agree >= 0.999, agree
        np.testing.assert_allclose(ps1.table.step.numpy(), np.asarray(js1.table.step),
                                   rtol=1e-5, atol=0)
        for key in ("step_grad_norm", "mean_step"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-4)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    for got, want in zip(tree_leaves(ps1.params), jax.tree.leaves(js1.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    assert ps1.step == int(js1.step) == 1


PRUNE = dict(warmup_steps=1, update_every=2, damping_steps=4, target_sparsity=0.5)


def test_prune_lm_table_refreshes_as_the_reference():
    """prune on an LM table through ``wrap_host_refresh``: four wrapped
    steps of the reference (jitted step, host refresh) and of the port from
    the same state: the losses agree, the mask is refreshed at steps 2 and
    4 to the scheduled sparsity; the refresh itself (the host clock synced,
    then the mask) is bitwise the reference's on the reference's table
    (rung 2); the microbatched data-parallel step refreshes too."""
    arch = "mamba2-370m"
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), embedding_method="prune")
    cfg = dataclasses.replace(configs.smoke_config(arch), embedding_method="prune")
    jt = jlm.LMTrainerConfig(prune=jpruning.PruneConfig(**PRUNE))
    pt = lm_trainer.LMTrainerConfig(prune=PruneConfig(**PRUNE))
    js = jlm.init_state(jax.random.PRNGKey(2), jcfg, jt)
    tree = jax.tree.map(np.asarray, js)
    ps = interop.lm_state_from_numpy(
        cfg, pt, params=tree.params,
        table={"weights": tree.table.weights, "mask": tree.table.mask,
               "step": int(tree.table.step)},
        table_opt={"step": tree.table_opt.step, "mu": tree.table_opt.mu, "nu": tree.table_opt.nu},
        opt={"step": tree.opt.step, "mu": tree.opt.mu, "nu": tree.opt.nu}, device="cpu")
    jstep = jlm.wrap_host_refresh(jax.jit(jlm.make_train_step(jcfg, jt)), jcfg, jt)
    pstep = lm_trainer.wrap_host_refresh(lm_trainer.make_train_step(cfg, pt), cfg, pt)
    jl, pl, kept = [], [], []
    for i in range(4):
        jb, pb = _batches(cfg.vocab_size, i)
        js, jm = jstep(js, jb)
        ps, pm = pstep(ps, pb)
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
        assert ps.table.step == int(js.table.step) == i + 1
        kept.append(float(ps.table.mask.float().mean()))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert kept[0] == 1.0 and kept[1] < 1.0 and kept[3] < kept[2] == kept[1]
    ratio = jpruning.prune_ratio(jpruning.PruneConfig(**PRUNE), jnp.int32(4))
    np.testing.assert_allclose(1.0 - kept[3], float(ratio), atol=2 / ps.table.mask.numel())
    agree = (ps.table.mask.numpy() == np.asarray(js.table.mask)).mean()
    assert agree >= 0.999, agree
    # Rung 2: the port's refresh of the reference's table after step 4.
    jspec = jlm.embedding_spec_of(jcfg, jt)
    jmethod = jmethods.get("prune")
    want = jax.jit(lambda t: jmethod.host_refresh(t, jspec))(jmethod.host_sync(js.table, 4, jspec))
    spec = lm_trainer.embedding_spec_of(cfg, pt)
    got = methods.get("prune").after_step(
        js.table._replace(weights=torch.from_numpy(np.array(js.table.weights)),
                          mask=torch.from_numpy(np.array(js.table.mask)), step=0), 4, spec)
    assert got.step == 4
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    # The data-parallel steps refresh the mask too, as the reference's do.
    dcfg = dataclasses.replace(configs.smoke_config("smollm-135m"), embedding_method="prune",
                               n_layers=1)
    dstep = dpm.make_lm_microbatch_step(dcfg, pt, 2)
    state = lm_trainer.init_state(dcfg, pt, device="cpu")
    for i in range(2):
        state, _ = dstep(state, _batches(dcfg.vocab_size, i, batch=4, seq=16)[1])
    assert state.table.step == 2 and float(state.table.mask.float().mean()) < 1.0


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("alpt", 4), ("lpt", 8), ("lpt", 4)])
def test_pad_to_tiles_table_has_the_reference_shapes(method, bits):
    """``LMTrainerConfig.pad_to_tiles``: the table's leaves have the
    reference's shapes (a scratch row, rows and width rounded to the
    sublane multiple); a step trains the live rows only."""
    arch = "deepseek-moe-16b"
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), embedding_method=method,
                               embedding_bits=bits, vocab_size=509, d_model=64)
    cfg = dataclasses.replace(configs.smoke_config(arch), embedding_method=method,
                              embedding_bits=bits, vocab_size=509)
    jt = jlm.LMTrainerConfig(pad_to_tiles=True)
    pt = lm_trainer.LMTrainerConfig(pad_to_tiles=True)
    want = jax.eval_shape(functools.partial(jlm.init_state, cfg=jcfg, tcfg=jt),
                          jax.ShapeDtypeStruct((2,), jnp.uint32)).table
    ps = lm_trainer.init_state(cfg, pt, device="cpu")
    got = ps.table
    assert tuple(got.codes.data.shape) == tuple(want.codes.data.shape)
    for name in ("step", "mu", "nu"):
        assert tuple(getattr(got, name).shape) == tuple(getattr(want, name).shape), name
    spec = lm_trainer.embedding_spec_of(cfg, pt)
    assert (spec.n_padded, spec.d_padded) == (jlm.embedding_spec_of(jcfg, jt).n_padded,
                                              jlm.embedding_spec_of(jcfg, jt).d_padded) == (
        512, 64)
    _, pb = _batches(cfg.vocab_size, 0)
    ps1, m = lm_trainer.make_train_step(cfg, pt)(ps, pb)
    assert np.isfinite(float(m["loss"]))
    scratch = slice(cfg.vocab_size, None)
    assert torch.equal(ps1.table.codes.data[scratch], ps.table.codes.data[scratch])


# ------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("arch", ["mamba2-370m", "deepseek-moe-16b"])
def test_checkpoint_resume_and_reference_cross_load(tmp_path, arch):
    """A port state saved after one step and restored resumes bitwise (every
    leaf, the generator); a reference ``LMTrainState`` saved with its
    ``save_pytree`` loads into the port at the reference's leaf paths and in
    its flatten order (``mamba.*``, ``moe.shared.*``), every leaf equal."""
    cfg = configs.smoke_config(arch)
    tcfg = lm_trainer.LMTrainerConfig()
    step_fn = lm_trainer.make_train_step(cfg, tcfg)

    def run(state, steps):
        losses = []
        for _ in range(steps):
            state, m = step_fn(state, _batches(cfg.vocab_size, state.step, seq=16)[1])
            losses.append(float(m["loss"]))
        return state, losses

    straight, l_straight = run(lm_trainer.init_state(cfg, tcfg, device="cpu"), 2)
    state, l1 = run(lm_trainer.init_state(cfg, tcfg, device="cpu"), 1)
    manager = CheckpointManager(tmp_path / "port")
    assert lm_trainer.save(manager, cfg, state, tcfg, force=True)
    state, l2 = run(lm_trainer.restore(manager, cfg, tcfg, device="cpu"), 1)
    assert l1 + l2 == l_straight
    for (pa, a), (pb, b) in zip(ckpt.flatten(lm_trainer.checkpoint_tree(cfg, state, tcfg)),
                                ckpt.flatten(lm_trainer.checkpoint_tree(cfg, straight, tcfg))):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=pa)

    jcfg, jt = jconfigs.smoke_config(arch), jlm.LMTrainerConfig()
    js = jlm.init_state(jax.random.PRNGKey(4), jcfg, jt)
    jckpt.save_pytree(js, tmp_path / "ref", step=0,
                      extra_meta=jembedding_manifest(jlm.embedding_spec_of(jcfg, jt)))
    ref_manager = CheckpointManager(tmp_path / "ref")
    ps = lm_trainer.restore(ref_manager, cfg, tcfg, device="cpu")
    entries = [e for e in ref_manager.read_manifest(0)["leaves"] if e["path"] != ".rng"]
    mine = [(p, x) for p, x in ckpt.flatten(lm_trainer.checkpoint_tree(cfg, ps, tcfg))
            if p != ".generator"]
    assert [p for p, _ in mine] == [e["path"] for e in entries]
    family = "['mamba']['A_log']" if cfg.ssm is not None else "['moe']['shared']['w_gate']"
    assert sum(family in p for p, _ in mine) == 3  # params, Adam mu and nu
    for (path, got), (_, want) in zip(mine, [
            (p, x) for p, x in jax.tree_util.tree_flatten_with_path(js)[0]
            if jax.tree_util.keystr(p) != ".rng"]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


# ------------------------------------------------------------- data parallel

RANKS = textwrap.dedent('''
    import datetime, hashlib, json, sys
    import torch, torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data.lm_synth import LMTokenStream
    from repro_torch.optim import tree_leaves
    from repro_torch.training import data_parallel as dpm, lm_trainer

    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))

    def digest(state):
        h = hashlib.sha256()
        for t in [*tree_leaves(state.params), *state.opt.mu, *state.opt.nu, state.table.codes.data,
                  state.table.step, state.table.mu, state.table.nu, state.generator.get_state()]:
            h.update(t.detach().contiguous().numpy().tobytes())
        return h.hexdigest()

    cfg = configs.smoke_config("mamba2-370m")
    out = {}
    for bits in (8, 32):
        tcfg = lm_trainer.LMTrainerConfig(lr=1e-3)
        dp = dpm.DPConfig(sync_bits=bits)
        step, twin = dpm.make_lm_dp_step(cfg, tcfg, dp=dp), dpm.make_lm_microbatch_step(
            cfg, tcfg, world, dp)
        a = lm_trainer.init_state(cfg, tcfg, device="cpu")
        b = lm_trainer.init_state(cfg, tcfg, device="cpu")
        losses = []
        for i in range(2):
            full = torch.from_numpy(LMTokenStream(cfg.vocab_size, 16, seed=17).batch(i, 2 * world))
            batch = {"tokens": full[:, :-1], "labels": full[:, 1:]}
            a, ma = step(a, batch)
            b, mb = twin(b, batch)
            losses.append([float(ma["loss"]), float(mb["loss"])])
        out[str(bits)] = [digest(a), digest(b), losses,
                          len(dpm.lm_grad_shapes(cfg, tcfg, a)), len(tree_leaves(a.params))]
    print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()
''')


def test_mamba2_dp_two_gloo_ranks_bitwise_their_twin(tmp_path):
    """``make_lm_dp_step`` follows the parameter tree: on mamba2's smoke
    config, two gloo processes at sync 8 and 32 end each step with every
    leaf, the generator and the losses bitwise their microbatched twin's,
    both ranks the same; the synced leaves are the table and every param."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    init = tmp_path / "init"
    procs = [subprocess.Popen([sys.executable, "-c", RANKS, str(r), "2", str(init)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr[-3000:]
            line = next(x for x in stdout.splitlines() if x.startswith("RESULT "))
            outs.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert outs[0] == outs[1]
    for bits, (dp_digest, twin_digest, losses, n_sync, n_params) in outs[0].items():
        assert dp_digest == twin_digest, bits
        assert all(a == b for a, b in losses), bits
        assert n_sync == n_params + 1


# ------------------------------------------------------------- CLIs


def test_train_and_serve_clis_take_the_new_archs(capsys):
    """``train lm --arch mamba2-370m --smoke --device cpu`` (with
    ``--pad-to-tiles`` the reference's padded table shape) and ``serve lm
    --arch deepseek-moe-16b --smoke --device cpu``: finite losses, every
    request served, no kernel launches on the CPU, no fallbacks."""
    assert train_cli.main(["lm", "--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "32",
                           "--pad-to-tiles"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(r["losses"]) == 2 and all(np.isfinite(r["losses"]))
    assert r["table_shape"] == [520, 64] and r["kernel_launches"] == {} and r["fallbacks"] == []
    assert serve_cli.main(["lm", "--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
                           "--requests", "3", "--gen", "4", "--prompt-len", "8"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["requests_completed"] == 3 and m["tokens_generated"] == 12
