"""The encoder (hubert-xlarge) against the JAX package, at its smoke config:
the ``embeds`` input mode, the gelu MLP, non-causal attention and an untied
head, through the loss, the trainer, the guard, the DP twin, checkpoints
and both CLIs.

The reference's ``lm_trainer.init_state`` builds params and the vocab table;
``interop`` carries the state into the port.  The same frames (seeded
normals drawn with numpy), labels (``LMTokenStream``) and, where a step
rounds stochastically, the reference's own SR noise go through both.  The
reference runs jitted.

The encoder's loss reads no table (its input is the frames, its head is
untied): ``jax.grad`` gives the table a zero gradient, and so does the
port, where ``torch.autograd.grad`` alone would raise.  The reference's
behaviour is kept: a zero gradient touches no row, so the table's codes,
Delta and row-Adam slots stay as they were and only its step count moves.

Tolerances, each with the gap measured when it was set:
- ``gelu_mlp`` (rung 3): within atol 2e-6, rtol 1e-6 (measured 9.5e-7
  absolute: XLA's and torch's tanh differ in the last bits);
- ``loss_fn`` (rung 3): loss within rtol 1e-6 (measured 0), each param
  gradient within 5e-5 of its largest entry (measured 6.3e-7);
- one train step: loss and grad norm within rtol 1e-5 (measured 0 and
  1.3e-7), params within atol 5e-5 (rung 3; measured 1.4e-6); the table
  (rung 2) bitwise: codes, Delta, row-Adam mu / nu and the count.
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

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.checkpoint.manager import embedding_manifest as jembedding_manifest
from repro.core import quant as jq
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.training import lm_trainer as jlm
from repro_torch import configs, interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.optim import tree_leaves
from repro_torch.serving.lm import LMEngine
from repro_torch.training import data_parallel as dpm
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")
ARCH = "hubert-xlarge"


@functools.lru_cache(maxsize=None)
def _pair(method="alpt", bits=8, seed=1):
    """(ref cfg, port cfg, ref tcfg, port tcfg, ref state, port state)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), embedding_method=method,
                               embedding_bits=bits)
    cfg = dataclasses.replace(configs.smoke_config(ARCH), embedding_method=method,
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


def _batches(cfg, i, batch=2, seq=32):
    """The step-``i`` encoder batch, (reference's, port's): seeded normal
    frames [batch, seq, d] and the token stream's labels modulo the
    vocabulary."""
    data = LMTokenStream(cfg.vocab_size, seq, seed=17).batch(i, batch)
    frames = np.random.RandomState(200 + i).normal(0, 1, (batch, seq, cfg.d_model))
    out = {"embeds": frames.astype(np.float32), "labels": data[:, 1:] % cfg.vocab_size}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _ref_noise(method, kn, shape):
    """The SR draw the reference's dense update takes for ``method``."""
    if method == "lpt":
        return torch.from_numpy(np.array(jq.sr_noise(kn, shape)))
    return torch.from_numpy(np.array(jq.sr_noise(jax.random.fold_in(kn, 1), shape)))


# ------------------------------------------------------------- layers, configs


@pytest.mark.parametrize("shape,d_ff", [((2, 32, 64), 128), ((3, 5, 80), 320)])
def test_gelu_mlp_matches_the_reference(shape, d_ff):
    """``gelu_mlp`` (the tanh approximation, as ``jax.nn.gelu``'s default)
    against the reference jitted, with nonzero biases (rung 3)."""
    rng = np.random.RandomState(d_ff)
    d = shape[-1]
    x, w_in, w_out = (rng.normal(0, s, sh).astype(np.float32)
                      for s, sh in ((2.0, shape), (d**-0.5, (d, d_ff)), (d_ff**-0.5, (d_ff, d))))
    b_in, b_out = (rng.normal(0, 0.5, (n,)).astype(np.float32) for n in (d_ff, d))
    want = jax.jit(jlayers.gelu_mlp)(x, w_in, b_in, w_out, b_out)
    got = L.gelu_mlp(*(torch.from_numpy(a) for a in (x, w_in, b_in, w_out, b_out)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "deepseek-67b"])
def test_configs_match_the_reference(arch):
    """Both new configs field for field and their ``SKIP_SHAPES``; the
    registry holds every reference architecture and ``check_supported``
    takes each at full and smoke size."""
    mod, jmod = configs.get_arch(arch), jconfigs.get_arch(arch)
    assert mod.SKIP_SHAPES == jmod.SKIP_SHAPES
    for make in ("full_config", "smoke_config"):
        got, want = getattr(mod, make)(), getattr(jmod, make)()
        names = {f.name for f in dataclasses.fields(got)} - {"dtype", "param_dtype"}
        assert names == {f.name for f in dataclasses.fields(want)} - {"dtype", "param_dtype"}
        assert {n: getattr(got, n) for n in names} == {n: getattr(want, n) for n in names}
        assert got.padded_heads == want.padded_heads and got.hd == want.hd
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
    for name in jconfigs.ARCHS:
        tfm.check_supported(configs.full_config(name))
        tfm.check_supported(configs.smoke_config(name))


def test_init_params_has_the_reference_layout():
    """The gelu MLP's leaves (``w_in``, ``b_in``, ``w_out``, ``b_out``; the
    biases zeros) in the reference's tree and flatten order, and the full
    config's parameter count (944,794,880, from the reference's shapes)."""
    cfg, jcfg = configs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    want = jax.eval_shape(functools.partial(jtfm.init_params, cfg=jcfg), key)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(t.shape) for t in tree_leaves(params)] == [a.shape for _, a in flat]
    assert sorted(params["blocks"][0]["mlp"]) == ["b_in", "b_out", "w_in", "w_out"]
    assert not params["blocks"][0]["mlp"]["b_in"].any()
    assert not params["blocks"][0]["mlp"]["b_out"].any()
    full = jax.eval_shape(functools.partial(jtfm.init_params, cfg=jconfigs.full_config(ARCH)),
                          key)
    assert sum(a.size for a in jax.tree.leaves(full)) == 944_794_880


# ------------------------------------------------------------- forward / loss


def test_assemble_embeds_is_the_batch_and_reads_no_table():
    """The ``embeds`` mode returns the frames bitwise the reference's, the
    table unread: a table of NaNs changes nothing."""
    jcfg, cfg, _, _, _, _ = _pair()
    jb, pb = _batches(cfg, 0)
    nan_table = np.full((cfg.vocab_size, cfg.d_model), np.nan, np.float32)
    want = jax.jit(lambda t, b: jtfm.assemble_embeds(t, b, jcfg))(nan_table, jb)
    got = tfm.assemble_embeds(torch.from_numpy(nan_table), pb, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), pb["embeds"].numpy())


def test_loss_fn_and_gradients_match_the_reference():
    """``loss_fn`` on frames (non-causal attention, the gelu MLP, the untied
    head) and its gradient w.r.t. every param (rung 3); the table's
    gradient is zeros on both sides."""
    jcfg, cfg, _, pt, js, ps = _pair()
    jb, pb = _batches(cfg, 0)
    jtab = np.array(jax.random.normal(jax.random.PRNGKey(3), (cfg.vocab_size, cfg.d_model)))
    (jl, _), (jgp, jgt) = jax.jit(jax.value_and_grad(
        lambda p, t: jtfm.loss_fn(p, t, jb, jcfg), argnums=(0, 1), has_aux=True))(js.params, jtab)
    loss, _ = tfm.loss_fn(ps.params, torch.from_numpy(jtab), pb, cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    (_, _), (g_emb, g_params) = lm_trainer.make_grad_fn(cfg, pt)(ps, pb)
    assert not np.asarray(jgt).any() and not g_emb.any()
    flat = jax.tree_util.tree_flatten_with_path(jgp)[0]
    assert len(flat) == len(g_params)
    assert any("['w_in']" in jax.tree_util.keystr(p) for p, _ in flat)
    for got, (path, want) in zip(g_params, flat):
        want = np.asarray(want)
        assert np.isfinite(want).all() and np.abs(want).max() > 0, path
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5 * np.abs(want).max(), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------- training


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("lpt", 4)])
def test_train_step_matches_the_reference(method, bits):
    """One step on frames from the reference's state with its SR noise: the
    table (codes, Delta, row-Adam mu / nu, count) bitwise (rung 2), its
    zero gradient leaving every row as it was, ALPT's Delta gradient zero;
    loss, grad norm and params within tolerance (rung 3)."""
    jcfg, cfg, jt, pt, js, ps = _pair(method, bits)
    jb, pb = _batches(cfg, 1)
    kn = jax.random.split(js.rng)[1]
    js1, jm = jax.jit(jlm.make_train_step(jcfg, jt))(js, jb)
    ps1, pm = lm_trainer.make_train_step(cfg, pt)(
        ps, pb, _ref_noise(method, kn, tuple(js.table.codes.shape)))
    np.testing.assert_array_equal(ps1.table.codes.data.numpy(), np.asarray(js1.table.codes.data))
    for name in ("step", "mu", "nu"):
        np.testing.assert_array_equal(getattr(ps1.table, name).numpy(),
                                      np.asarray(getattr(js1.table, name)), err_msg=name)
        assert torch.equal(getattr(ps1.table, name), getattr(ps.table, name)), name
    assert torch.equal(ps1.table.codes.data, ps.table.codes.data)
    assert ps1.table.count == int(js1.table.count) == 1
    if method == "alpt":
        assert float(pm["step_grad_norm"]) == float(jm["step_grad_norm"]) == 0.0
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    for got, want in zip(tree_leaves(ps1.params), jax.tree.leaves(js1.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


def test_guard_and_data_parallel_carry_the_frames():
    """The guarded step passes the frames through (bitwise the plain step);
    the microbatched DP twin cuts ``embeds`` [B, T, d] on B: at sync 32 over
    2 shards its loss is the exact mean of each half's ``loss_fn``."""
    _, cfg, _, pt, _, ps = _pair()
    _, pb = _batches(cfg, 3, batch=4)
    plain, pm = lm_trainer.make_train_step(cfg, pt)(lm_trainer.clone_state(ps), pb)
    guarded, gm = lm_trainer.make_train_step(cfg, dataclasses.replace(pt, guard=True))(
        lm_trainer.clone_state(ps), pb)
    assert float(gm["loss"]) == float(pm["loss"]) and gm["guard_skipped"] == 0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(guarded.params),
                                                 tree_leaves(plain.params)))
    parts = dpm._lm_shards(pb, 2)
    assert [tuple(x.shape) for x in parts["embeds"]] == [(2, 32, cfg.d_model)] * 2
    assert torch.equal(torch.cat(parts["embeds"]), pb["embeds"])
    twin = dpm.make_lm_microbatch_step(cfg, pt, 2, dpm.DPConfig(sync_bits=32))
    _, tm = twin(lm_trainer.clone_state(ps), pb)
    table = lm_trainer.table_fp_of(ps, cfg, pt)
    halves = [tfm.loss_fn(ps.params, table, {k: v[s] for k, v in pb.items()}, cfg)[0]
              for s in (slice(0, 2), slice(2, 4))]
    assert float(tm["loss"]) == float((halves[0] + halves[1]) * np.float32(0.5))


def test_checkpoint_resume_and_reference_cross_load(tmp_path):
    """A port state saved after one step resumes bitwise (every leaf, the
    generator); a reference ``LMTrainState`` saved with its ``save_pytree``
    loads leaf for leaf at the reference's paths (the gelu MLP's four
    leaves with their Adam moments)."""
    cfg = configs.smoke_config(ARCH)
    tcfg = lm_trainer.LMTrainerConfig()
    step_fn = lm_trainer.make_train_step(cfg, tcfg)

    def run(state, steps):
        losses = []
        for _ in range(steps):
            state, m = step_fn(state, _batches(cfg, state.step, seq=16)[1])
            losses.append(float(m["loss"]))
        return state, losses

    straight, l_straight = run(lm_trainer.init_state(cfg, tcfg, device="cpu"), 2)
    state, l1 = run(lm_trainer.init_state(cfg, tcfg, device="cpu"), 1)
    manager = CheckpointManager(tmp_path / "port")
    assert lm_trainer.save(manager, cfg, state, tcfg, force=True)
    state, l2 = run(lm_trainer.restore(manager, cfg, tcfg, device="cpu"), 1)
    assert l1 + l2 == l_straight
    for (pa, a), (pb_, b) in zip(ckpt.flatten(lm_trainer.checkpoint_tree(cfg, state, tcfg)),
                                 ckpt.flatten(lm_trainer.checkpoint_tree(cfg, straight, tcfg))):
        assert pa == pb_
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=pa)

    jcfg, _, jt, _, js, _ = _pair()
    jckpt.save_pytree(js, tmp_path / "ref", step=0,
                      extra_meta=jembedding_manifest(jlm.embedding_spec_of(jcfg, jt)))
    ref_manager = CheckpointManager(tmp_path / "ref")
    ps = lm_trainer.restore(ref_manager, cfg, tcfg, device="cpu")
    mine = [(p, x) for p, x in ckpt.flatten(lm_trainer.checkpoint_tree(cfg, ps, tcfg))
            if p != ".generator"]
    ref = [(jax.tree_util.keystr(p), x) for p, x in jax.tree_util.tree_flatten_with_path(js)[0]
           if jax.tree_util.keystr(p) != ".rng"]
    assert [p for p, _ in mine] == [p for p, _ in ref]
    for name in ("['w_in']", "['b_in']", "['w_out']", "['b_out']"):
        assert sum(name in p for p, _ in mine) == 3, name  # params, Adam mu and nu
    for (path, got), (_, want) in zip(mine, ref):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


# ------------------------------------------------------------- CLIs


def test_cli_batch_is_the_references():
    """The CLI's encoder batch: the reference's ``RandomState(step)`` normal
    frames in float32, the stream's labels modulo the vocabulary, no
    tokens."""
    cfg = configs.smoke_config(ARCH)
    stream = LMTokenStream(cfg.vocab_size, 16, seed=17)
    batch = train_cli.lm_batch(cfg, stream, 3, 2, 16, torch.device("cpu"))
    assert sorted(batch) == ["embeds", "labels"]
    want = np.random.RandomState(3).normal(0, 1, (2, 16, cfg.d_model))
    np.testing.assert_array_equal(batch["embeds"].numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))
    np.testing.assert_array_equal(batch["labels"].numpy(),
                                  stream.batch(3, 2)[:, 1:] % cfg.vocab_size)


def test_train_and_serve_clis_take_the_encoder(capsys):
    """``train lm --arch hubert-xlarge --smoke --device cpu`` trains on
    frames (finite losses, no launches on the CPU, no fallbacks), also with
    ``--dp-compress-bits 8`` (one rank), which the reference takes for an
    ``embeds`` arch; ``serve lm`` prints the reference's line and exits 0
    at full size without building anything; the engine refuses the arch."""
    argv = ["lm", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "32", "--log-every", "0"]
    for extra in ([], ["--dp-compress-bits", "8", "--mesh-data", "1"]):
        assert train_cli.main(argv + extra) == 0
        r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert r["arch"] == "hubert-smoke" and len(r["losses"]) == 2
        assert all(math.isfinite(x) for x in r["losses"])
        assert r["kernel_launches"] == {} and r["fallbacks"] == []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve_cli.main(["lm", "--arch", ARCH, "--device", "cpu"]) == 0
    assert out.getvalue().strip() == "[serve] encoder-only arch has no decode; nothing to serve"
    _, cfg, _, pt, _, ps = _pair()
    with pytest.raises(ValueError, match="no decode path"):
        LMEngine.from_state(ps, cfg, pt, batch=1, max_len=8)
