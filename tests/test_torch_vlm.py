"""The VLM family (qwen2-vl-7b) against the JAX package, at its smoke config:
M-RoPE, QKV bias and the ``mixed`` input mode.

The reference's ``lm_trainer.init_state`` builds params and the vocab table;
its QKV biases, zeros at init, are replaced by seeded normals so that the
bias path carries weight; ``interop`` carries the state into the port.  The
same token batches (``LMTokenStream``), a visual prefix drawn from a numpy
seed, grid M-RoPE positions (the prefix a 2 x 4 patch grid: temporal 0,
height = row, width = col; the text after it equal in all three streams,
from the prefix's largest position + 1 on) and, where a step rounds
stochastically, the reference's own SR noise go through both.  The
reference runs jitted.

Tolerances, each with the gap measured when it was set:
- ``mrope_angles``: atol 5e-5, rtol 1e-5, the port's ``rope_angles`` test's
  (measured 6.0e-8: XLA's and torch's sin / cos); three equal streams are
  ``rope_angles`` bit for bit;
- ``assemble_embeds``: bitwise;
- ``loss_fn`` (rung 3): loss within rtol 1e-6 (measured 1.4e-7), the table
  gradient within atol 2e-6 on entries up to ~0.055 (measured 5.4e-8), the
  prefix gradient within atol 2e-6 (measured 7.2e-9), each param gradient
  within 5e-5 of its largest entry (measured 1.2e-6);
- one train step: loss, grad norms and mean Delta within rtol 1e-5
  (measured 2.2e-7), params within atol 5e-5 (rung 3; measured 6.8e-6);
  the table (rung 2): LPT's write-back from the reference's gradients and
  noise bitwise (codes, Delta, row-Adam mu / nu), ALPT's whole step with
  the reference's noise leaves codes and Delta bitwise;
- serving: prefill and decode logits and the KV caches within atol 5e-5
  (logits also rtol 1e-5; measured 1.6e-6 and 1.4e-6), the greedy tokens
  equal.
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
from repro import methods as jmethods
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
from repro_torch.optim import tree_leaves, tree_like
from repro_torch.serving.lm import LMEngine, LMRequest
from repro_torch.training import data_parallel as dpm
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")
ARCH = "qwen2-vl-7b"
TOL = dict(atol=5e-5, rtol=1e-5)
GRID = (2, 4)  # the smoke config's visual prefix of 8 as rows x cols


def grid_positions(b: int, t: int, grid: tuple[int, int]) -> np.ndarray:
    """[3, b, t] int32: the prefix a ``grid`` of patches (temporal 0, height
    = row, width = col), the text after it equal in all three streams from
    the prefix's largest position + 1 on."""
    rows, cols = grid
    p = rows * cols
    pos = np.zeros((3, t), np.int32)
    pos[1, :p] = np.repeat(np.arange(rows), cols)
    pos[2, :p] = np.tile(np.arange(cols), rows)
    pos[:, p:] = max(rows, cols) + np.arange(t - p)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, t)))


@functools.lru_cache(maxsize=None)
def _pair(method="alpt", bits=8, seed=1):
    """(ref cfg, port cfg, ref tcfg, port tcfg, ref state, port state), the
    reference's QKV biases set to seeded normals first."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), embedding_method=method,
                               embedding_bits=bits)
    cfg = dataclasses.replace(configs.smoke_config(ARCH), embedding_method=method,
                              embedding_bits=bits)
    jt, pt = jlm.LMTrainerConfig(), lm_trainer.LMTrainerConfig()
    js = jlm.init_state(jax.random.PRNGKey(seed), jcfg, jt)
    rng = np.random.RandomState(seed)
    attn = dict(js.params["blocks"][0]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(rng.normal(0, 0.5, attn[name].shape).astype(np.float32))
    block = dict(js.params["blocks"][0], attn=attn)
    js = js._replace(params=dict(js.params, blocks=[block]))
    tree = jax.tree.map(np.asarray, js)
    table = {"codes": np.asarray(js.table.codes.data), "step": tree.table.step,
             "mu": tree.table.mu, "nu": tree.table.nu, "count": tree.table.count}
    ps = interop.lm_state_from_numpy(
        cfg, pt, params=tree.params, table=table,
        opt={"step": tree.opt.step, "mu": tree.opt.mu, "nu": tree.opt.nu}, device="cpu")
    return jcfg, cfg, jt, pt, js, ps


def _batches(cfg, i, batch=2, seq=32, grid=True):
    """The step-``i`` mixed batch, (reference's, port's): tokens and labels,
    a seeded normal prefix and grid (or, ``grid=False``, no) positions."""
    data = LMTokenStream(cfg.vocab_size, seq, seed=17).batch(i, batch)
    prefix = np.random.RandomState(100 + i).normal(
        0, 1, (batch, cfg.visual_prefix, cfg.d_model)).astype(np.float32)
    out = {"tokens": data[:, :-1], "labels": data[:, 1:], "prefix_embeds": prefix}
    if grid:
        out["positions"] = grid_positions(batch, seq, GRID)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _ref_noise(method, kn, shape):
    """The SR draw the reference's dense update takes for ``method``."""
    if method == "lpt":
        return torch.from_numpy(np.array(jq.sr_noise(kn, shape)))
    return torch.from_numpy(np.array(jq.sr_noise(jax.random.fold_in(kn, 1), shape)))


# ------------------------------------------------------------- layers


@pytest.mark.parametrize("hd,sections,base", [(16, (2, 3, 3), 10000.0),
                                              (128, (16, 24, 24), 10000.0),
                                              (80, (10, 15, 15), 1_000_000.0)])
def test_mrope_angles_match_the_reference(hd, sections, base):
    """Grid positions within the rope test's tolerance of the reference
    jitted; three equal streams are ``rope_angles`` bit for bit; sections
    that do not sum to ``head_dim // 2`` raise."""
    pos = grid_positions(2, 300, (16, 16))
    pos[:, 1] += 7  # the two rows differ
    cos, sin = L.mrope_angles(torch.from_numpy(pos), hd, sections, base)
    jcos, jsin = jax.jit(jlayers.mrope_angles, static_argnums=(1, 2, 3))(pos, hd, sections,
                                                                         base)
    assert cos.shape == (2, 300, hd // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL)
    text = np.ascontiguousarray(np.broadcast_to(pos[2][None], pos.shape))
    got = L.mrope_angles(torch.from_numpy(text), hd, sections, base)
    want = L.rope_angles(torch.from_numpy(pos[2]), hd, base)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="must sum to head_dim"):
        L.mrope_angles(torch.from_numpy(pos), hd, (1, 1, 1), base)


def test_config_and_positions_match_the_reference():
    """The configs' derived shapes (head dim, padded heads) are the
    reference's (their fields: tests/test_torch_lm_families.py);
    ``check_supported`` takes M-RoPE and the mixed mode; ``default_positions``
    gives three equal streams, as the reference's."""
    for make in ("full_config", "smoke_config"):
        got, want = getattr(configs, make)(ARCH), getattr(jconfigs, make)(ARCH)
        assert got.padded_heads == want.padded_heads and got.hd == want.hd
        tfm.check_supported(got)
    cfg, jcfg = configs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    pos = tfm.default_positions(2, 9, cfg)
    assert pos.shape == (3, 2, 9)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jtfm.default_positions(2, 9, jcfg)))


# ------------------------------------------------------------- forward / loss


def test_assemble_embeds_mixed_is_bitwise():
    """The visual prefix replaces token positions 0..P-1, the rest are the
    tokens' rows: bitwise the reference's."""
    jcfg, cfg, jt, _, js, _ = _pair()
    jb, pb = _batches(cfg, 0)
    jspec = jlm.embedding_spec_of(jcfg, jt)
    jtab = jmethods.get(jspec.method).dense_table(js.table, jspec)
    want = jax.jit(lambda t, b: jtfm.assemble_embeds(t, b, jcfg))(jtab, jb)
    got = tfm.assemble_embeds(torch.from_numpy(np.array(jtab)), pb, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :cfg.visual_prefix].numpy(),
                                  pb["prefix_embeds"].numpy())


@pytest.mark.parametrize("grid", [True, False])
def test_loss_fn_and_gradients_match_the_reference(grid):
    """``loss_fn`` with the prefix and grid (or default) positions, and its
    gradients w.r.t. every param (the QKV biases and the untied head among
    them), the dense table and the prefix (rung 3)."""
    jcfg, cfg, jt, _, js, ps = _pair()
    jb, pb = _batches(cfg, 0, grid=grid)
    jspec = jlm.embedding_spec_of(jcfg, jt)
    jtab = jmethods.get(jspec.method).dense_table(js.table, jspec)

    def jloss(p, t, prefix):
        return jtfm.loss_fn(p, t, dict(jb, prefix_embeds=prefix), jcfg)

    (jl, _), (jgp, jgt, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                          has_aux=True))(
        js.params, jtab, jb["prefix_embeds"])
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(ps.params)]
    tab = torch.from_numpy(np.array(jtab)).requires_grad_(True)
    prefix = pb["prefix_embeds"].clone().requires_grad_(True)
    loss, aux = tfm.loss_fn(tree_like(ps.params, leaves), tab, dict(pb, prefix_embeds=prefix),
                            cfg)
    g_tab, g_prefix, *g_params = torch.autograd.grad(loss, [tab, prefix, *leaves])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert float(aux) == 0.0
    np.testing.assert_allclose(g_tab.numpy(), np.asarray(jgt), atol=2e-6, rtol=0)
    np.testing.assert_allclose(g_prefix.numpy(), np.asarray(jgx), atol=2e-6, rtol=0)
    flat = jax.tree_util.tree_flatten_with_path(jgp)[0]
    assert len(flat) == len(g_params)
    names = [jax.tree_util.keystr(p) for p, _ in flat]
    assert any("['bq']" in n for n in names) and "['head']" in names
    for got, (path, want) in zip(g_params, flat):
        want = np.asarray(want)
        assert np.isfinite(want).all() and np.abs(want).max() > 0, path
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5 * np.abs(want).max(), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------- training


def test_alpt_train_step_matches_the_reference():
    """One ALPT-8 step with the prefix and grid positions (the Delta recompute
    reads both), from the reference's state with its SR noise: the table's
    codes and Delta bitwise (rung 2), loss, grad norms and params within
    tolerance (rung 3)."""
    jcfg, cfg, jt, pt, js, ps = _pair("alpt", 8)
    jb, pb = _batches(cfg, 1)
    kn = jax.random.split(js.rng)[1]
    js1, jm = jax.jit(jlm.make_train_step(jcfg, jt))(js, jb)
    ps1, pm = lm_trainer.make_train_step(cfg, pt)(ps, pb, _ref_noise(
        "alpt", kn, tuple(js.table.codes.shape)))
    np.testing.assert_array_equal(ps1.table.codes.data.numpy(), np.asarray(js1.table.codes.data))
    np.testing.assert_array_equal(ps1.table.step.numpy(), np.asarray(js1.table.step))
    assert ps1.table.count == int(js1.table.count) == 1
    for key in ("loss", "grad_norm", "step_grad_norm", "mean_step"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    for got, want in zip(tree_leaves(ps1.params), jax.tree.leaves(js1.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    assert ps1.step == int(js1.step) == 1


def test_lpt_train_step_matches_the_reference():
    """LPT-8: the port's ``make_apply_fn`` given the reference's gradients and
    noise leaves the table (codes, Delta, row-Adam mu / nu) bitwise the
    reference's (rung 2); the port's own whole step on the mixed batch
    within tolerance (rung 3)."""
    jcfg, cfg, jt, pt, js, ps = _pair("lpt", 8)
    jb, pb = _batches(cfg, 2)
    kn = jax.random.split(js.rng)[1]
    noise = _ref_noise("lpt", kn, tuple(js.table.codes.shape))
    (jl, jaux), (jg_tab, jg_params) = jax.jit(jlm.make_grad_fn(jcfg, jt))(js, jb)
    lr = np.float32(3e-4)
    js1, jm = jax.jit(lambda s, la, g, kn: jlm.make_apply_fn(jcfg, jt)(
        s, la, g, lr=lr, rng=kn, kn=kn, batch_rows=int(jb["labels"].size)))(
            js, (jl, jaux), (jg_tab, jg_params), kn)
    grads = (torch.from_numpy(np.array(jg_tab)),
             [torch.from_numpy(np.array(g)) for g in jax.tree.leaves(jg_params)])
    ps1, _ = lm_trainer.make_apply_fn(cfg, pt)(
        ps, (torch.tensor(float(jl)), torch.tensor(float(jaux))), grads, lr=float(lr),
        noise=noise, batch_rows=int(jb["labels"].size))
    np.testing.assert_array_equal(ps1.table.codes.data.numpy(), np.asarray(js1.table.codes.data))
    for name in ("step", "mu", "nu"):
        np.testing.assert_array_equal(getattr(ps1.table, name).numpy(),
                                      np.asarray(getattr(js1.table, name)), err_msg=name)
    ps2, pm = lm_trainer.make_train_step(cfg, pt)(ps, pb, noise)
    np.testing.assert_allclose(float(pm["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    for got, want in zip(tree_leaves(ps2.params), jax.tree.leaves(js1.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


def test_guard_and_data_parallel_carry_the_mixed_batch():
    """The guarded step and the host-refresh wrapper pass the prefix and
    positions through (bitwise the plain step); the microbatched DP twin
    slices positions [3, B, T] on B: at sync 32 over 2 shards its loss is
    the exact mean of each half's ``loss_fn``."""
    _, cfg, _, pt, _, ps = _pair()
    _, pb = _batches(cfg, 3, batch=4)
    plain, pm = lm_trainer.make_train_step(cfg, pt)(lm_trainer.clone_state(ps), pb)
    wrapped = lm_trainer.wrap_host_refresh(
        lm_trainer.make_train_step(cfg, dataclasses.replace(pt, guard=True)), cfg, pt)
    guarded, gm = wrapped(lm_trainer.clone_state(ps), pb)
    assert float(gm["loss"]) == float(pm["loss"]) and gm["guard_skipped"] == 0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(guarded.params),
                                                 tree_leaves(plain.params)))
    assert torch.equal(guarded.table.codes.data, plain.table.codes.data)
    twin = dpm.make_lm_microbatch_step(cfg, pt, 2, dpm.DPConfig(sync_bits=32))
    _, tm = twin(lm_trainer.clone_state(ps), pb)
    table = lm_trainer.table_fp_of(ps, cfg, pt)
    halves = [tfm.loss_fn(ps.params, table, {k: (v[:, s] if k == "positions" else v[s])
                                             for k, v in pb.items()}, cfg)[0]
              for s in (slice(0, 2), slice(2, 4))]
    want = (halves[0] + halves[1]) * np.float32(0.5)
    assert float(tm["loss"]) == float(want)


# ------------------------------------------------------------- serving


def test_prefill_and_decode_match_the_reference():
    """The text path (three equal streams): teacher-forced ``prefill`` and
    ``decode_step`` logits of the int8 table within tolerance of the
    reference's jitted, per-slot cache lengths across a batch of 2; the
    greedy tokens equal; the KV caches (rope'd, biased k) within tolerance."""
    jcfg, cfg, jt, pt, js, ps = _pair()
    jspec = jlm.embedding_spec_of(jcfg, jt)
    jtable = jmethods.get(jspec.method).serving_state(js.table, jspec)
    table = LMEngine.build_serving_state(ps.table, lm_trainer.embedding_spec_of(cfg, pt))
    max_len = 24
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = jax.jit(functools.partial(jtfm.prefill, cfg=jcfg, max_len=max_len))(
        js.params, jtable, jnp.asarray(prompt))
    pl, pc = tfm.prefill(ps.params, table, torch.from_numpy(prompt), cfg, max_len)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for c, j in zip(pc, jc):
        for key in ("k", "v"):
            np.testing.assert_allclose(c[key].numpy(), np.asarray(j[key]), atol=TOL["atol"],
                                       rtol=0)
    jdec = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))
    lens = np.array([12, 12], np.int32)
    for i in range(6):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        np.testing.assert_array_equal(pl.argmax(-1).numpy(), tok)
        jl, jc = jdec(js.params, jtable, jnp.asarray(tok), jc, jnp.asarray(lens + i))
        pl, pc = tfm.decode_step(ps.params, table, torch.from_numpy(tok), pc,
                                 torch.from_numpy(lens + i), cfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


def test_engine_serves_the_text_path():
    """``LMEngine`` serves the VLM's text path on the CPU: every request, its
    tokens in the vocabulary, the same tokens in reverse arrival order; an
    ``embeds`` (encoder-only) config is refused, as in the reference."""
    _, cfg, _, pt, _, ps = _pair()
    rng = np.random.RandomState(9)
    reqs = [(rng.randint(0, cfg.vocab_size, n).astype(np.int32), g)
            for n, g in ((12, 6), (8, 3), (10, 1), (12, 4))]
    done = {}
    for order in (range(len(reqs)), reversed(range(len(reqs)))):
        engine = LMEngine.from_state(ps, cfg, pt, batch=2, max_len=24)
        for i in order:
            engine.submit(LMRequest(prompt=reqs[i][0], max_new=reqs[i][1], rid=i))
        out = engine.run()
        assert sorted(out) == list(range(len(reqs)))
        assert all(len(out[i]) == reqs[i][1] for i in out)
        assert all(0 <= t < cfg.vocab_size for toks in out.values() for t in toks)
        done = done or out
        assert out == done
    with pytest.raises(ValueError, match="no decode path"):
        LMEngine.from_state(ps, dataclasses.replace(cfg, input_mode="embeds"), pt, batch=1,
                            max_len=8)


# ------------------------------------------------------------- checkpoints


def test_reference_checkpoint_cross_loads(tmp_path):
    """A reference ``LMTrainState`` of the smoke config saved with its
    ``save_pytree`` loads into the port leaf for leaf, at the reference's
    paths and flatten order (the QKV biases and the untied head with their
    Adam moments), and trains on; a port checkpoint resumes bitwise."""
    jcfg, cfg, jt, pt, js, _ = _pair()
    jckpt.save_pytree(js, tmp_path / "ref", step=0,
                      extra_meta=jembedding_manifest(jlm.embedding_spec_of(jcfg, jt)))
    manager = CheckpointManager(tmp_path / "ref")
    ps = lm_trainer.restore(manager, cfg, pt, device="cpu")
    mine = [(p, x) for p, x in ckpt.flatten(lm_trainer.checkpoint_tree(cfg, ps, pt))
            if p != ".generator"]
    ref = [(jax.tree_util.keystr(p), x) for p, x in jax.tree_util.tree_flatten_with_path(js)[0]
           if jax.tree_util.keystr(p) != ".rng"]
    assert [p for p, _ in mine] == [e["path"] for e in manager.read_manifest(0)["leaves"]
                                    if e["path"] != ".rng"]
    for name in ("['bq']", "['bk']", "['bv']", "['head']"):
        assert sum(name in p for p, _ in mine) == 3, name  # params, Adam mu and nu
    assert len(mine) == len(ref)
    for (path, got), (_, want) in zip(mine, ref):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)
    step = lm_trainer.make_train_step(cfg, pt)
    state, m = step(ps, _batches(cfg, 0)[1])
    assert math.isfinite(float(m["loss"]))
    port = CheckpointManager(tmp_path / "port")
    assert lm_trainer.save(port, cfg, state, pt, force=True)
    back = lm_trainer.restore(port, cfg, pt, device="cpu")
    a, _ = step(state, _batches(cfg, 1)[1])
    b, _ = step(back, _batches(cfg, 1)[1])
    for (pa, x), (pb_, y) in zip(ckpt.flatten(lm_trainer.checkpoint_tree(cfg, a, pt)),
                                 ckpt.flatten(lm_trainer.checkpoint_tree(cfg, b, pt))):
        assert pa == pb_
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=pa)


# ------------------------------------------------------------- CLIs


def test_train_and_serve_clis_take_the_vlm(capsys):
    """``train lm --arch qwen2-vl-7b --smoke --device cpu`` trains on the
    mixed batch (finite losses, no launches on the CPU, no fallbacks);
    ``--dp-compress-bits`` exits 2 with the reference's message; ``serve lm
    --arch qwen2-vl-7b --smoke --device cpu`` serves every request."""
    assert train_cli.main(["lm", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                           "--batch", "2", "--seq", "32", "--log-every", "0"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["arch"] == "qwen2-vl-smoke" and len(r["losses"]) == 2
    assert all(math.isfinite(x) for x in r["losses"])
    assert r["kernel_launches"] == {} and r["fallbacks"] == []
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exc:
        train_cli.main(["lm", "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
                        "--dp-compress-bits", "8"])
    assert exc.value.code == 2
    assert "does not support mixed-input (M-RoPE positions) archs" in err.getvalue()
    assert serve_cli.main(["lm", "--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                           "3", "--gen", "4", "--prompt-len", "8"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["requests_completed"] == 3 and m["tokens_generated"] == 12


def test_cli_batch_is_the_references():
    """The CLI's mixed batch: the reference's ``RandomState(step)`` normal
    prefix in float32 and three equal position streams."""
    cfg = configs.smoke_config(ARCH)
    batch = train_cli.lm_batch(cfg, LMTokenStream(cfg.vocab_size, 16, seed=17), 3, 2, 16,
                               torch.device("cpu"))
    want = np.random.RandomState(3).normal(0, 1, (2, cfg.visual_prefix, cfg.d_model))
    np.testing.assert_array_equal(batch["prefix_embeds"].numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))
    assert batch["positions"].shape == (3, 2, 16) and batch["positions"].dtype == torch.int32
    np.testing.assert_array_equal(batch["positions"].numpy(),
                                  np.broadcast_to(np.arange(16), (3, 2, 16)))
    assert batch["tokens"].shape == batch["labels"].shape == (2, 16)
