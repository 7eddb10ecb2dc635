"""The port's checkpoints (``repro_torch.checkpoint``) against the reference's
protocol and states, on the CPU.

- The manager: a dtype-keeping round trip, keep-k, the ``save_every``
  cadence, uncommitted directories invisible, a leaf-count mismatch refused,
  a corrupted leaf refused and the restore falling back to the last good
  step (as tests/test_checkpoint.py and tests/test_faults.py hold the
  reference's).
- Resume: for every registered method, N steps straight equal k steps,
  save, restore into a fresh trainer and N - k steps, bit for bit (state,
  generator, losses); the saved embedding leaves are exactly
  ``memory_bytes(stored=True)``.
- Cross-loading: a reference state, stepped and saved in-process with
  ``repro.checkpoint.save_pytree``, loads into the port leaf for leaf; one
  row step (integer tables) or Adam step (float leaves) from it, given the
  reference's row gradients and SR noise, equals the reference's bit for
  bit (rung 2), and one whole trainer step with its noise and dropout masks
  gives its loss within rtol 1e-5 (rung 3).  The LM: one step from a
  reference checkpoint within tests/test_torch_lm_train.py's one-step
  tolerances.
- Serving: ``from_checkpoint`` against ``from_state`` bitwise; the artifact
  holds codes + Delta only, its table bytes ``memory_bytes(training=False)``;
  a method, schema or packing mismatch is refused before any array loads.
- The CLI: resume, a corrupted newest step skipped, and SIGTERM saving and
  exiting 75.

The reference runs jitted, kernels off (its own kernels-on == kernels-off
contract); the port takes the plain versions on the CPU.
"""
import contextlib
import dataclasses
import io
import json
import pathlib
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import methods as jmethods
from repro.checkpoint.manager import embedding_manifest as jembedding_manifest
from repro.core import pruning as jprune
from repro.core import quant as jq
from repro.models import ctr as jctr
from repro.optim import adam_update as jadam_update
from repro.training import ctr_trainer as jtr
from repro.training import lm_trainer as jlm
from repro_torch import configs, methods
from repro_torch.checkpoint import CheckpointManager, CorruptCheckpointError
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import pruning
from repro_torch.core.codestore import CodeStore
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.launch import train as train_cli
from repro_torch.models import ctr as pctr
from repro_torch.optim import adam_update, tree_leaves
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.serving.lm import LMEngine, LMRequest
from repro_torch.training import ctr_trainer, lm_trainer
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig

f32 = np.float32
CARDS = (17, 29, 11, 41)
DATA_CFG = CTRDatasetConfig(name="ckpt", n_fields=4, cardinalities=CARDS, teacher_rank=3, seed=7)
DATA = CTRSynthetic(DATA_CFG)
WIDTHS, DROPOUT = (16,), 0.2
PRUNE = dict(target_sparsity=0.5, damping=0.5, damping_steps=1, warmup_steps=2, update_every=3)


def _spec_kw(method, bits=8, pad=False):
    kw = dict(method=method, n=DATA_CFG.n_features, d=8, bits=bits, init_scale=0.05,
              pad_to_tiles=pad, field_cards=CARDS, field_bits=(8, 4, 8, 2))
    if method == "lpt":
        kw["clip_value"] = 0.1
    return kw


def _pcfg(method, bits=8, pad=False, seed=0):
    spec = methods.EmbeddingSpec(**_spec_kw(method, bits, pad),
                                 prune=pruning.PruneConfig(**PRUNE))
    return TrainerConfig(spec=spec, dcn=pctr.DCNConfig(4, 8, 1, WIDTHS, DROPOUT), lr=3e-3,
                         seed=seed)


def _flat(tree):
    """A checkpoint tree's leaves, the generator aside, as numpy."""
    return [(p, _np(leaf)) for p, leaf in ckpt.flatten(tree) if p != ".generator"]


def _np(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, p
        np.testing.assert_array_equal(x, y, err_msg=p)


# ------------------------------------------------------------------ the manager


def _tree():
    from typing import NamedTuple

    class Table(NamedTuple):
        codes: CodeStore
        step: torch.Tensor
        count: int

    rs = np.random.RandomState(0)
    codes = torch.from_numpy(rs.randint(-128, 128, (5, 3)).astype(np.int8))
    return {
        "table": Table(codes=CodeStore(data=codes, bits=8, n=5, d=3, packed=False),
                       step=torch.from_numpy(rs.rand(5).astype(f32)), count=np.int32(7)),
        "packed": torch.from_numpy(rs.randint(0, 256, (4, 2)).astype(np.uint8)),
        "mask": torch.from_numpy(rs.rand(4, 3) > 0.5),
        "list": [torch.zeros(2), None, np.float32(1.5)],
    }


def test_round_trip_keeps_dtypes_paths_and_structure(tmp_path):
    tree = _tree()
    ckpt.save_pytree(tree, tmp_path, step=3, extra_meta={"note": 1})
    m = json.loads((tmp_path / "step_000000003" / "manifest.json").read_text())
    assert m["step"] == 3 and m["note"] == 1 and "Table(codes=CodeStore(data=*)" in m["treedef"]
    assert [e["path"] for e in m["leaves"]] == [
        "['list'][0]", "['list'][2]", "['mask']", "['packed']", "['table'].codes.data",
        "['table'].step", "['table'].count"]
    assert [e["dtype"] for e in m["leaves"]] == ["float32", "float32", "bool", "uint8", "int8",
                                                 "float32", "int32"]
    assert all(set(e) == {"path", "file", "dtype", "shape", "crc32"} for e in m["leaves"])
    by_path, _ = ckpt.load_pytree(tmp_path, device="cpu")  # the tree rebuilt from the paths

    def keyed(t):
        return {tuple(ckpt.path_keys(p)): _np(leaf) for p, leaf in ckpt.flatten(t)}

    got, want = keyed(by_path), keyed(tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w)
    assert by_path["table"]["codes"]["data"].dtype == torch.int8
    assert by_path["mask"].dtype == torch.bool and by_path["packed"].dtype == torch.uint8
    assert by_path["list"][1] is None and by_path["list"][2].item() == 1.5
    assert int(by_path["table"]["count"]) == 7


def test_cuda_is_the_default_device(tmp_path):
    ckpt.save_pytree({"a": torch.zeros(2)}, tmp_path, step=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ckpt.load_pytree(tmp_path)


def test_keep_k_removes_the_oldest(tmp_path):
    m = CheckpointManager(tmp_path, keep=2, save_every=1)
    for s in range(1, 6):
        assert m.maybe_save({"x": torch.full((2,), float(s))}, s)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000004", "step_000000004.COMMITTED", "step_000000005",
        "step_000000005.COMMITTED"]
    tree, manifest = m.restore(device="cpu")
    assert manifest["step"] == 5 and float(tree["x"][0]) == 5.0


@pytest.mark.parametrize("step,force,saved", [(0, False, False), (0, True, True),
                                              (3, False, False), (4, False, True),
                                              (5, True, True), (8, False, True)])
def test_save_every_cadence(tmp_path, step, force, saved):
    m = CheckpointManager(tmp_path, keep=3, save_every=4)
    assert m.maybe_save({"x": torch.zeros(1)}, step, force=force) == saved
    assert m.latest_step() == (step if saved else None)


def test_uncommitted_directory_is_invisible(tmp_path):
    ckpt.save_pytree({"x": torch.zeros(1)}, tmp_path, step=2)
    ckpt.save_pytree({"x": torch.ones(1)}, tmp_path, step=5)
    (tmp_path / "step_000000005.COMMITTED").unlink()  # a crash before the marker
    (tmp_path / ".tmp_step_000000009_x").mkdir()
    m = CheckpointManager(tmp_path)
    assert m.latest_step() == 2
    tree, manifest = m.restore(device="cpu")
    assert manifest["step"] == 2 and float(tree["x"][0]) == 0.0


@pytest.mark.parametrize("method,bits,packed,metadata,what", [
    ("lsq", 8, True, True, "restore refused.*embedding method 'alpt' != configured 'lsq'"),
    ("alpt", 4, True, True, "schema differs.*storage layout differs"),
    ("alpt", 4, False, True, "restore refused.*: embedding storage layout differs"),
    ("lsq", 8, True, False, "checkpoint table has 5 leaves, the config's 'lsq' table 2"),
    ("alpt", 4, True, False, r"shapes differ at \[\('codes', 'data'\)\]")])
def test_leaf_count_and_shape_mismatch_refused(tmp_path, method, bits, packed, metadata, what):
    """An ALPT-8 checkpoint restored under another method, width or packing
    is refused: from the manifest's embedding metadata before any array
    loads (the leaf files are garbage here), or, in a manifest without it,
    from the leaves before any converts.  ALPT-4 unpacked holds int8 [n, d]
    codes as ALPT-8 does; only the recorded storage tells them apart."""
    tr = CTRTrainer(_pcfg("alpt"), device="cpu")
    manager = CheckpointManager(tmp_path)
    tr.save(manager, tr.init_state(), force=True)
    if metadata:
        for leaf in (tmp_path / "step_000000000").glob("leaf_*.npy"):
            leaf.write_bytes(b"not an array")  # any load would fail on these
    else:
        manifest = manager.read_manifest(0)
        for key in [k for k in manifest if k.startswith("embedding_")]:
            del manifest[key]
        (tmp_path / "step_000000000" / "manifest.json").write_text(json.dumps(manifest))
    cfg = _pcfg(method, bits)
    cfg = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec, packed=packed))
    with pytest.raises(ValueError, match=what):
        CTRTrainer(cfg, device="cpu").restore(CheckpointManager(tmp_path))


def _flip_byte(path: pathlib.Path, at: int = -3) -> None:
    raw = bytearray(path.read_bytes())
    raw[at] ^= 0xFF
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("how", ["flip", "truncate"])
def test_corrupted_leaf_falls_back_to_the_last_good_step(tmp_path, how):
    m = CheckpointManager(tmp_path, keep=3, save_every=1)
    for s in (2, 4):
        m.maybe_save({"w": torch.full((64,), float(s)), "c": torch.arange(3, dtype=torch.int8)}, s)
    leaf = tmp_path / "step_000000004" / "leaf_00001.npy"
    if how == "flip":
        _flip_byte(leaf)
    else:  # an artifact without checksums (older manifests) that will not parse
        manifest = m.read_manifest(4)
        for e in manifest["leaves"]:
            del e["crc32"]
        (tmp_path / "step_000000004" / "manifest.json").write_text(json.dumps(manifest))
        leaf.write_bytes(leaf.read_bytes()[:20])
    with pytest.raises(CorruptCheckpointError, match="crc32" if how == "flip" else "unreadable"):
        m.restore(step=4, device="cpu")
    tree, manifest = m.restore(device="cpu")
    assert manifest["step"] == 2 and m.corrupt_steps == [4] and float(tree["w"][0]) == 2.0
    _flip_byte(tmp_path / "step_000000002" / "leaf_00000.npy")
    with pytest.raises(CorruptCheckpointError, match="all 2 committed checkpoints"):
        CheckpointManager(tmp_path).restore(device="cpu")


def test_unflatten_paths_reads_the_reference_spellings():
    pairs = [(".a.b", 1), (".a['c'][1]", 3), (".a['c'][0]", 2), ("['t'][<flat index 1>]", 5),
             ("['t'][<flat index 0>].data", 4)]
    assert ckpt.unflatten_paths(pairs) == {"a": {"b": 1, "c": [2, 3]},
                                           "t": [{"data": 4}, 5]}


# ------------------------------------------------------------- resume, every method


@pytest.mark.parametrize("method", methods.available())
def test_resume_is_bitwise_for_every_method(tmp_path, method):
    """6 steps straight == 3 steps, save, a fresh trainer's restore, 3 steps:
    every leaf, the generator's state and the losses (DCN dropout 0.2, so
    the masks come from the restored generator; 4-bit packed codes where a
    method packs; prune's mask refreshed at steps 3 and 6)."""
    cfg = _pcfg(method, bits=4)
    tr = CTRTrainer(cfg, device="cpu")
    straight, h_straight = tr.fit(DATA, steps=6, batch_size=32)
    manager = CheckpointManager(tmp_path, keep=3, save_every=100)
    state, h1 = tr.fit(DATA, steps=3, batch_size=32)
    assert tr.save(manager, state) is False and tr.save(manager, state, force=True)
    del state
    fresh = CTRTrainer(cfg, device="cpu")
    state = fresh.restore(manager)
    assert state.step == 3
    state, h2 = fresh.fit(DATA, steps=3, batch_size=32, state=state)
    assert [h["loss"] for h in h1 + h2] == [h["loss"] for h in h_straight]
    _assert_trees_equal(ctr_trainer.checkpoint_tree(cfg, state),
                        ctr_trainer.checkpoint_tree(cfg, straight))
    assert torch.equal(state.generator.get_state(), straight.generator.get_state())
    manifest = manager.read_manifest(3)
    # The table's arrays; its 0-d counters (count, prune's clock, r) aside.
    emb = sum(int(np.prod(e["shape"], dtype=np.int64)) * np.dtype(e["dtype"]).itemsize
              for e in manifest["leaves"] if e["path"].startswith(".emb_state") and e["shape"])
    m = methods.get(method)
    assert emb == m.memory_bytes(straight.emb_state, cfg.spec, stored=True)
    assert manifest["embedding_method"] == method and manifest["config_hash"]
    assert ckpt.check_embedding_manifest(manifest, cfg.spec) == []


def test_manifest_names_a_mismatched_config(tmp_path):
    cfg = _pcfg("alpt")
    tr = CTRTrainer(cfg, device="cpu")
    tr.save(CheckpointManager(tmp_path), tr.init_state(), force=True)
    manifest = CheckpointManager(tmp_path).read_manifest(0)
    assert ckpt.check_embedding_manifest(manifest, _pcfg("lsq").spec) == [
        "checkpoint embedding method 'alpt' != configured 'lsq'"]
    packed = _pcfg("alpt", bits=4)
    assert ckpt.check_embedding_manifest(manifest, packed.spec) == [
        "embedding table schema differs (shape/dtype/leaves)",
        "embedding storage layout differs (bits/packing/container)"]


@pytest.mark.parametrize("method", methods.available())
@pytest.mark.parametrize("pad", [False, True])
def test_manifest_embedding_keys_equal_the_reference(method, pad):
    """``embedding_manifest``: method, capabilities, the leaf schema (from the
    abstract init) and the storage layout, as the reference writes them."""
    for bits in (8, 4):
        kw = _spec_kw(method, bits, pad)
        want = json.loads(json.dumps(jembedding_manifest(jmethods.EmbeddingSpec(**kw))))
        assert json.loads(json.dumps(ckpt.embedding_manifest(methods.EmbeddingSpec(**kw)))) == want


# ------------------------------------------------------------------ cross-loading


def _reference_masks(key, batch):
    masks = []
    for width in WIDTHS:
        key, sub = jax.random.split(key)
        masks.append(torch.from_numpy(np.array(jax.random.bernoulli(sub, 1.0 - DROPOUT,
                                                                    (batch, width)))))
    return masks


def _reference_draws(method, key, shape, spec):
    """The SR draws the reference's ``fused_row_step`` takes from ``key``."""
    def sr(k):
        return torch.from_numpy(np.array(jq.sr_noise(k, shape)))

    if method == "lpt":
        return [sr(key)]
    if method == "alpt":
        return [sr(key), sr(jax.random.fold_in(key, 1))]
    if method == "qr_alpt":
        k_rem, k_quo = jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)
        return [sr(k) for k in (k_rem, k_quo, jax.random.fold_in(k_rem, 1),
                                jax.random.fold_in(k_quo, 1))]
    return [sr(jax.random.fold_in(key, g)) for g in range(methods.get(method).noise_draws(spec))]


def _reference_checkpoint(tmp_path, method, bits):
    """A reference trainer 2 steps in, saved with its own ``save_pytree``
    and manifest; the batch of step 3."""
    kw = _spec_kw(method, bits)
    jcfg = jtr.TrainerConfig(spec=jmethods.EmbeddingSpec(**kw, prune=jprune.PruneConfig(**PRUNE)),
                             dcn=jctr.DCNConfig(4, 8, 1, WIDTHS, DROPOUT), lr=3e-3)
    jt = jtr.CTRTrainer(jcfg)
    js = jt.init_state()
    for i in range(2):
        js, _ = jt.train_step(js, *DATA.batch("train", i, 32))
        if method == "prune":
            js = js._replace(emb_state=js.emb_state._replace(step=js.step))
    jckpt.save_pytree(js, tmp_path, step=2, extra_meta=jembedding_manifest(jcfg.spec))
    return jt, js


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("lpt", 4), ("lsq", 8), ("prune", 8),
                                         ("qr_alpt", 8), ("mixed", 8)])
def test_reference_checkpoint_loads_and_steps_bitwise(tmp_path, method, bits):
    jt, js = _reference_checkpoint(tmp_path, method, bits)
    pcfg = _pcfg(method, bits)
    manager = CheckpointManager(tmp_path)
    manifest = manager.read_manifest(2)
    assert ckpt.check_embedding_manifest(manifest, pcfg.spec) == []
    pt = CTRTrainer(pcfg, device="cpu")
    ps = pt.restore(manager)
    assert ps.step == 2
    # Leaf for leaf: the reference's paths (its rng aside) and values.
    mine = ckpt.flatten(ctr_trainer.checkpoint_tree(pcfg, ps))
    assert [p for p, _ in mine if p != ".generator"] == [
        e["path"] for e in manifest["leaves"] if e["path"] != ".rng"]
    flat_j = [leaf for path, leaf in jax.tree_util.tree_flatten_with_path(js)[0]
              if jax.tree_util.keystr(path) != ".rng"]
    for (path, got), want in zip((x for x in mine if x[0] != ".generator"), flat_j):
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=path)
    assert torch.equal(ps.generator.get_state(), torch.Generator().manual_seed(
        ckpt.reference_generator_seed(pcfg.seed, 2)).get_state())

    # Rung 2: the embedding update from the loaded state, given the
    # reference's row gradients (a linear loss: the gradient is the weight
    # tensor exactly) and SR noise.
    ids, labels = DATA.batch("train", 2, 32)
    spec, jspec = pcfg.spec, jt.spec
    pm, jm = methods.get(method), jmethods.get(method)
    wts = (np.random.RandomState(3).randn(*ids.shape, 8) * 0.3).astype(f32)
    key = jax.random.PRNGKey(11)
    lr = f32(3e-3)
    if pm.is_integer_table:
        jstate, _, _, _ = jax.jit(lambda s, k: jm.fused_row_step(
            s, jnp.asarray(ids), spec=jspec, loss_from_rows=lambda r, p: jnp.sum(r * p),
            dense_params=jnp.asarray(wts), dense_opt=None, update_dense=lambda g, o, p: (p, o),
            lr=lr, weight_decay=5e-8, noise_key=k))(js.emb_state, key)
        tw = torch.from_numpy(wts)
        pstate, _ = pm.fused_row_step(
            ps.emb_state, torch.from_numpy(ids), spec=spec,
            loss_from_rows=lambda r: torch.sum(r * tw), dense_params=[],
            update_dense=lambda g: None, lr=float(lr), weight_decay=5e-8,
            noise=_reference_draws(method, key, (ids.size, spec.d_padded), spec))
        got = ckpt.flatten(pstate)
        want = jax.tree_util.tree_flatten_with_path(jstate)[0]
        assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=path)
    else:
        jparams = jm.trainable_params(js.emb_state, jspec)

        def jloss(p):
            rows = jm.lookup(jm.with_params(js.emb_state, p, jspec), jnp.asarray(ids), jspec)
            return jnp.sum(rows * wts)

        g = jax.jit(jax.grad(jloss))(jparams)
        jnew, jopt = jax.jit(lambda g, o, p: jadam_update(g, o, p, lr, weight_decay=5e-8))(
            g, js.emb_opt, jparams)
        pparams = pm.trainable_params(ps.emb_state, spec)
        pnew, popt = adam_update([torch.from_numpy(np.array(x)) for x in jax.tree.leaves(g)],
                                 ps.emb_opt, tree_leaves(pparams), float(lr), weight_decay=5e-8)
        for got, want in zip(pnew + popt.mu + popt.nu,
                             jax.tree.leaves(jnew) + jax.tree.leaves(jopt.mu)
                             + jax.tree.leaves(jopt.nu)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert popt.step == int(jopt.step) == 3

    # Rung 3: one whole trainer step with the reference's masks and noise,
    # from a fresh restore (the row step above updated the table in place).
    ps = pt.restore(manager)
    if pm.is_integer_table:
        kd, kn = jax.random.split(js.rng, 3)[1:]
        noise = _reference_draws(method, kn, (ids.size, spec.d_padded), spec)
    else:
        kd, noise = jax.random.split(js.rng)[1], None
    js3, jmet = jt.train_step(js, ids, labels)
    ps3, pmet = pt.train_step(ps, ids, labels, masks=_reference_masks(kd, 32), noise=noise)
    np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    assert ps3.step == int(js3.step) == 3 and pmet["lr"] == float(jmet["lr"])


def test_reference_lm_checkpoint_loads_and_steps(tmp_path):
    """A reference ``LMTrainState`` (ALPT-8, the reduced SmolLM), one step in
    and saved with its ``save_pytree``, loads into the port; the next step
    with the reference's noise matches it within the one-step tolerances of
    tests/test_torch_lm_train.py (loss rtol 1e-6, params atol 5e-5, codes
    and Delta equal)."""
    jcfg = jconfigs.smoke_config("smollm-135m")
    cfg = configs.smoke_config("smollm-135m")
    jt, pt = jlm.LMTrainerConfig(), lm_trainer.LMTrainerConfig()
    jstep = jax.jit(jlm.make_train_step(jcfg, jt))
    data = LMTokenStream(cfg.vocab_size, 64, seed=17)

    def batches(i):
        full = data.batch(i, 2)
        return ({"tokens": jnp.asarray(full[:, :-1]), "labels": jnp.asarray(full[:, 1:])},
                {"tokens": torch.from_numpy(full[:, :-1]), "labels": torch.from_numpy(full[:, 1:])})

    js = jlm.init_state(jax.random.PRNGKey(1), jcfg, jt)
    js, _ = jstep(js, batches(0)[0])
    jckpt.save_pytree(js, tmp_path, step=1,
                      extra_meta=jembedding_manifest(jlm.embedding_spec_of(jcfg, jt)))
    manager = CheckpointManager(tmp_path)
    assert ckpt.check_embedding_manifest(manager.read_manifest(1),
                                         lm_trainer.embedding_spec_of(cfg, pt)) == []
    ps = lm_trainer.restore(manager, cfg, pt, device="cpu")
    mine = ckpt.flatten(lm_trainer.checkpoint_tree(cfg, ps, pt))
    assert [p for p, _ in mine if p != ".generator"] == [
        e["path"] for e in manager.read_manifest(1)["leaves"] if e["path"] != ".rng"]
    shape = tuple(js.table.codes.shape)
    kn = jax.random.split(js.rng)[1]
    noise = torch.from_numpy(np.array(jq.sr_noise(jax.random.fold_in(kn, 1), shape)))
    jb, pb = batches(1)
    js2, jm = jstep(js, jb)
    ps2, pm = lm_trainer.make_train_step(cfg, pt)(ps, pb, noise)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-6)
    for got, want in zip(tree_leaves(ps2.params), jax.tree.leaves(js2.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    np.testing.assert_array_equal(ps2.table.codes.data.numpy(), np.asarray(js2.table.codes.data))
    np.testing.assert_array_equal(ps2.table.step.numpy(), np.asarray(js2.table.step))
    assert ps2.step == int(js2.step) == 2 and ps2.table.count == 2


@pytest.mark.parametrize("method", ["alpt", "fp"])
def test_lm_resume_is_bitwise(tmp_path, method):
    cfg = dataclasses.replace(configs.smoke_config("smollm-135m"), embedding_method=method)
    tcfg = lm_trainer.LMTrainerConfig()
    step_fn = lm_trainer.make_train_step(cfg, tcfg)
    data = LMTokenStream(cfg.vocab_size, 32, seed=17)

    def run(state, steps):
        losses = []
        for _ in range(steps):
            full = torch.from_numpy(data.batch(state.step, 2))
            state, m = step_fn(state, {"tokens": full[:, :-1], "labels": full[:, 1:]})
            losses.append(float(m["loss"]))
        return state, losses

    straight, l_straight = run(lm_trainer.init_state(cfg, tcfg, device="cpu"), 4)
    state, l1 = run(lm_trainer.init_state(cfg, tcfg, device="cpu"), 2)
    manager = CheckpointManager(tmp_path)
    assert lm_trainer.save(manager, cfg, state, tcfg, force=True)
    state, l2 = run(lm_trainer.restore(manager, cfg, tcfg, device="cpu"), 2)
    assert l1 + l2 == l_straight
    _assert_trees_equal(lm_trainer.checkpoint_tree(cfg, state, tcfg),
                        lm_trainer.checkpoint_tree(cfg, straight, tcfg))
    assert torch.equal(state.generator.get_state(), straight.generator.get_state())


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("method", methods.available())
def test_ctr_engine_from_checkpoint_equals_from_state(tmp_path, method):
    cfg = _pcfg(method, bits=4)
    state, _ = CTRTrainer(cfg, device="cpu").fit(DATA, steps=2, batch_size=32)
    ckpt.save_serving_checkpoint(tmp_path, step=2, params=state.dense.param_tree(),
                                 table=state.emb_state, spec=cfg.spec)
    manifest = CheckpointManager(tmp_path).read_manifest(2)
    table_leaves = [e for e in manifest["leaves"] if e["path"].startswith("['table']")]
    m = methods.get(method)
    n_live = cfg.spec.n
    if m.is_integer_table or method in ("lsq", "pact"):
        # codes + Delta only: no fp32 [n, d] table, no optimizer slot
        assert all(e["dtype"] in ("int8", "uint8") or len(e["shape"]) == 1
                   for e in table_leaves)
    table_bytes = sum(int(np.prod(e["shape"])) * np.dtype(e["dtype"]).itemsize
                      for e in table_leaves)
    if method not in ("hash", "prune"):  # their export is the fp32 eval table
        assert table_bytes == m.memory_bytes(state.emb_state, cfg.spec, training=False)
    ids, _ = DATA.batch("test", 0, 40)
    results = []
    for engine in (CTREngine.from_state(state, cfg, batch=16),
                   CTREngine.from_checkpoint(tmp_path, cfg, batch=16, device="cpu")):
        rids = [engine.submit(CTRRequest(ids=r)) for r in ids]
        done = engine.run()
        results.append([done[r] for r in rids])
        assert engine.n_rows == n_live
    assert results[0] == results[1]


@pytest.mark.parametrize("method,bits", [("alpt", 4), ("qr_lpt", 8), ("mixed", 8), ("fp", 8)])
def test_serving_artifact_layout_equals_the_reference(tmp_path, method, bits):
    kw = _spec_kw(method, bits)
    jspec = jmethods.EmbeddingSpec(**kw)
    js = jmethods.get(method).init(jax.random.PRNGKey(0), jspec)
    jparams = jctr.init_dcn(jax.random.PRNGKey(1), jctr.DCNConfig(4, 8, 1, WIDTHS))
    jckpt.save_serving_checkpoint(tmp_path / "ref", step=1, params=jparams, table=js, spec=jspec)
    cfg = _pcfg(method, bits)
    state = CTRTrainer(cfg, device="cpu").init_state()
    ckpt.save_serving_checkpoint(tmp_path / "port", step=1, params=state.dense.param_tree(),
                                 table=state.emb_state, spec=cfg.spec)

    def layout(d):
        m = CheckpointManager(tmp_path / d).read_manifest(1)
        return [(e["path"], e["dtype"], e["shape"]) for e in m["leaves"]]

    assert layout("port") == layout("ref")
    # The reference's artifact serves in the port too.
    engine = CTREngine.from_checkpoint(tmp_path / "ref", cfg, batch=8, device="cpu")
    assert engine.n_rows == cfg.spec.n


def test_serving_restore_refuses_a_mismatch_before_loading(tmp_path):
    cfg = _pcfg("alpt", bits=4)  # codes packed two to a byte
    state = CTRTrainer(cfg, device="cpu").init_state()
    ckpt.save_serving_checkpoint(tmp_path, step=1, params=state.dense.param_tree(),
                                 table=state.emb_state, spec=cfg.spec)
    for leaf in (tmp_path / "step_000000001").glob("leaf_*.npy"):
        leaf.write_bytes(b"not an array")  # any load would fail on these
    for spec, what in (
            (_pcfg("lsq", bits=4).spec, "embedding method 'alpt' != configured 'lsq'"),
            (dataclasses.replace(cfg.spec, packed=False), "schema differs.*storage layout"),
            (_pcfg("alpt", bits=8).spec, "schema differs.*storage layout"),
            (dataclasses.replace(cfg.spec, pad_to_tiles=True), "schema differs")):
        with pytest.raises(ValueError, match=what):
            ckpt.restore_serving_checkpoint(tmp_path, spec, device="cpu")
    with pytest.raises(CorruptCheckpointError):  # the right config gets to the arrays
        ckpt.restore_serving_checkpoint(tmp_path, cfg.spec, device="cpu")


@pytest.mark.parametrize("bits", [8, 4])
def test_lm_engine_from_checkpoint_equals_from_state(tmp_path, bits):
    cfg = dataclasses.replace(configs.smoke_config("smollm-135m"), embedding_bits=bits)
    state = lm_trainer.init_state(cfg, device="cpu")
    spec = lm_trainer.embedding_spec_of(cfg)
    ckpt.save_serving_checkpoint(tmp_path, step=0, params=state.params, table=state.table,
                                 spec=spec)
    leaves = CheckpointManager(tmp_path).read_manifest(0)["leaves"]
    table = [e for e in leaves if e["path"].startswith("['table']")]
    assert [e["dtype"] for e in table] == ["int8" if bits == 8 else "uint8", "float32"]
    assert sum(int(np.prod(e["shape"])) * np.dtype(e["dtype"]).itemsize for e in table) == \
        methods.get(spec.method).memory_bytes(state.table, spec, training=False)
    prompts = [np.random.RandomState(i).randint(0, cfg.vocab_size, 5 + 3 * i).astype(np.int32)
               for i in range(3)]
    out = []
    for engine in (LMEngine.from_state(state, cfg, batch=2, max_len=32),
                   LMEngine.from_checkpoint(tmp_path, cfg, batch=2, max_len=32, device="cpu")):
        for i, p in enumerate(prompts):
            engine.submit(LMRequest(prompt=p, max_new=6, rid=i))
        out.append(engine.run())
        assert engine.resident_embedding_bytes == sum(
            int(np.prod(e["shape"])) * np.dtype(e["dtype"]).itemsize for e in table)
    assert out[0] == out[1]


# ------------------------------------------------------------------ the CLI


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, lines, json.loads(lines[-1]) if rc == 0 else None


CTR_ARGV = ["ctr", "--device", "cpu", "--scale", "0.001", "--batch", "32", "--method", "alpt"]


@pytest.mark.parametrize("corrupt", [False, True])
def test_cli_resumes_and_replays_the_missed_steps(tmp_path, corrupt):
    _, _, straight = _cli(CTR_ARGV + ["--steps", "6"])
    d = str(tmp_path / "ck")
    rc, _, first = _cli(CTR_ARGV + ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", d])
    assert rc == 0 and first["losses"] == straight["losses"][:4]
    assert CheckpointManager(d).latest_step() == 4
    if corrupt:
        _flip_byte(tmp_path / "ck" / "step_000000004" / "leaf_00002.npy")
    rc, lines, second = _cli(CTR_ARGV + ["--steps", "6", "--ckpt-dir", d])
    start = 2 if corrupt else 4
    assert rc == 0 and f"[train] ctr resumed from step {start}" in lines
    assert second["start_step"] == start and second["losses"] == straight["losses"][start:]
    assert second.get("corrupt_checkpoints") == ([4] if corrupt else None)
    assert CheckpointManager(d).latest_step() == 6


def test_cli_saves_and_exits_75_on_sigterm(tmp_path, monkeypatch):
    batch = CTRSynthetic.batch

    def batch_then_signal(self, split, i, size):
        if split == "train" and i == 1:
            signal.raise_signal(signal.SIGTERM)  # arrives during step 2
        return batch(self, split, i, size)

    monkeypatch.setattr(CTRSynthetic, "batch", batch_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    d = tmp_path / "ck"
    rc, lines, _ = _cli(CTR_ARGV + ["--steps", "6", "--ckpt-dir", str(d)])
    assert rc == 75 and lines[-1].startswith("[train] preempted at step 2")
    assert CheckpointManager(d).latest_step() == 2
    assert signal.getsignal(signal.SIGTERM) is before  # the handler is put back


def test_lm_cli_resumes(tmp_path):
    argv = ["lm", "--arch", "smollm-135m", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--log-every", "0"]
    _, _, straight = _cli(argv + ["--steps", "4"])
    d = str(tmp_path / "ck")
    rc, _, first = _cli(argv + ["--steps", "2", "--ckpt-every", "1", "--ckpt-dir", d])
    assert rc == 0 and sorted(p.name for p in (tmp_path / "ck").glob("*.COMMITTED")) == [
        "step_000000001.COMMITTED", "step_000000002.COMMITTED"]
    rc, lines, second = _cli(argv + ["--steps", "4", "--ckpt-dir", d])
    assert rc == 0 and "[train] resumed from step 2" in lines
    assert first["losses"] + second["losses"] == straight["losses"]
