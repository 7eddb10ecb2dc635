"""Per-method conformance suite of the port, mirroring
tests/test_methods_conformance.py: every registered embedding method honors
the ``EmbeddingMethod`` protocol (init, lookup, the trainable_params /
with_params round trip, memory accounting, full-shape tables, one train
step in both formulations), the kernels-on and kernels-off paths agree bit
for bit for every integer-table method (the CTR row formulation, padded and
not, and the LM dense formulation), and the dense formulation of the
composed methods equals the reference's given its state, gradient and SR
noise (rung 2).  The reference's sharding-spec and checkpoint cases come
with the ports of data parallelism and checkpoints.

The port's kernels-on path takes the plain versions on the CPU, through
the same dispatch as on the card; kernels-off takes ``core.lpt``'s own
plain path.  The reference runs jitted, kernels off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import methods as jmethods
from repro_torch import configs, interop
from repro_torch import methods
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.models.ctr import DCNConfig
from repro_torch.optim import tree_leaves, tree_like
from repro_torch.training import lm_trainer
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig

N, D = 103, 8
ALL_METHODS = methods.available()
INT_TABLE_METHODS = [m for m in ALL_METHODS if methods.get(m).is_integer_table]
f32 = np.float32


def spec_of(name, **kw):
    return methods.EmbeddingSpec(method=name, n=N, d=D, bits=8, init_scale=0.05, **kw)


def state_of(name, seed=0):
    spec = spec_of(name)
    return methods.get(name).init(torch.Generator().manual_seed(seed), spec), spec


def leaves(x):
    """Every tensor of a state (codes containers by their bytes)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if hasattr(x, "data") and hasattr(x, "packed"):
        return [x.data]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    return []


def to_np(x):
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if hasattr(x, "data") and hasattr(x, "packed"):
        return np.array(x.data)
    if isinstance(x, (tuple, list)):
        return [to_np(v) for v in x]
    if isinstance(x, (int, float)):
        return x
    return np.array(x)


def test_registry_equals_the_reference():
    assert ALL_METHODS == jmethods.available()
    for name in ALL_METHODS:
        assert methods.get(name).is_integer_table == jmethods.get(name).is_integer_table
        assert methods.get(name).has_learned_step == jmethods.get(name).has_learned_step
        assert methods.get(name).has_host_refresh == jmethods.get(name).has_host_refresh


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown embedding method"):
        methods.get("nope")
    with pytest.raises(ValueError, match="unknown embedding method"):
        methods.EmbeddingSpec(method="nope", n=4, d=2).is_integer_table


def test_double_registration_rejected():
    with pytest.raises(ValueError, match="already registered"):
        @methods.register("fp")
        class Dup(methods.EmbeddingMethod):  # pragma: no cover - never built
            pass


def test_noise_draws_follow_the_spec():
    draws = {m: methods.get(m).noise_draws(spec_of(m)) for m in ALL_METHODS}
    assert draws == {"alpt": 2, "fp": 0, "hash": 0, "lpt": 1, "lsq": 0, "mixed": 1,
                     "pact": 0, "prune": 0, "qr_alpt": 4, "qr_lpt": 2}
    three = methods.EmbeddingSpec(method="mixed", n=N, d=D, field_cards=(3, 60, 40),
                                  field_bits=(8, 4, 2))
    assert methods.get("mixed").noise_draws(three) == 3


@pytest.mark.parametrize("name", ALL_METHODS)
def test_lookup_shapes_and_dtypes(name):
    state, spec = state_of(name)
    m = methods.get(name)
    ids = torch.tensor([[0, 5, 17], [N - 1, 2, 5]], dtype=torch.int32)
    rows = m.lookup(state, ids, spec)
    assert rows.shape == (2, 3, D) and rows.dtype == torch.float32
    assert bool(torch.isfinite(rows).all())
    # Same id -> same row, whatever its position in the batch.
    assert torch.equal(rows[0, 1], rows[1, 2])


@pytest.mark.parametrize("name", ALL_METHODS)
def test_trainable_params_roundtrip_and_capability_consistency(name):
    state, spec = state_of(name)
    m = methods.get(name)
    params = m.trainable_params(state, spec)
    assert (params is None) == m.is_integer_table
    rebuilt = m.with_params(state, params, spec)
    for a, b in zip(leaves(state), leaves(rebuilt), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ALL_METHODS)
def test_memory_bytes_match_the_reference_and_compressors_compress(name):
    """The port's accounting equals the reference's at the same geometry (the
    reference's state traced abstractly: its accounting reads shapes),
    except prune's inference bytes, which read the mask: the port counts
    them exactly (4 bytes per kept weight) where the reference scales by a
    float32 mean."""
    jspec = jmethods.EmbeddingSpec(method=name, n=N, d=D, bits=8, init_scale=0.05)
    js = jax.eval_shape(lambda k: jmethods.get(name).init(k, jspec), jax.random.PRNGKey(0))
    state, spec = state_of(name)
    m = methods.get(name)
    train_b = m.memory_bytes(state, spec, training=True)
    inf_b = m.memory_bytes(state, spec, training=False)
    assert train_b == jmethods.get(name).memory_bytes(js, jspec, training=True)
    if name != "prune":
        assert inf_b == jmethods.get(name).memory_bytes(js, jspec, training=False)
    assert train_b > 0 and inf_b > 0
    fp_bytes = N * D * 4
    if m.is_integer_table:
        assert train_b < fp_bytes  # no fp32 master copy, ever
    if name in ("lsq", "pact"):
        assert train_b >= fp_bytes and inf_b < fp_bytes


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("name", ALL_METHODS)
def test_memory_bytes_stored_counts_every_tensor_the_state_holds(name, pad, bits):
    """``memory_bytes(stored=True)`` is what the state's tensors hold: the
    paper's accounting plus the row-optimizer slots of integer tables, and
    prune's bool mask at one byte per weight (the paper counts one bit)."""
    spec = spec_of(name, pad_to_tiles=pad)
    spec = dataclasses.replace(spec, bits=bits)
    m = methods.get(name)
    state = m.init(torch.Generator().manual_seed(1), spec)
    held = sum(t.numel() * t.element_size() for t in leaves(state))
    assert m.memory_bytes(state, spec, stored=True) == held
    paper = m.memory_bytes(state, spec, training=True)
    if m.is_integer_table:
        slots = held - paper
        assert slots > 0 and slots % (2 * 4) == 0  # Adam's mu and nu, f32
    elif name == "prune":
        assert held - paper == N * D - N * D // 8
    else:
        assert held == paper


@pytest.mark.parametrize("name", ALL_METHODS)
def test_dense_and_serving_tables_are_full_shape(name):
    state, spec = state_of(name)
    m = methods.get(name)
    table = m.eval_table(state, spec)
    assert table.shape == (N, D) and table.dtype == torch.float32
    served = m.serving_state(state, spec).rows(torch.arange(N, dtype=torch.int32))
    assert served.shape == (N, D) and bool(torch.isfinite(served).all())
    if m.is_integer_table:  # the integer-resident table serves the training rows
        assert torch.equal(served, table)


DATA_CFG = CTRDatasetConfig(name="conf", n_fields=4, cardinalities=(17, 29, 11, 41),
                            teacher_rank=3, seed=7)
DATA = CTRSynthetic(DATA_CFG)


def _trainer(name, *, use_kernels=True, pad=False):
    spec = methods.EmbeddingSpec(method=name, n=DATA_CFG.n_features, d=8, bits=8,
                                 init_scale=0.05, use_kernels=use_kernels, pad_to_tiles=pad,
                                 field_cards=DATA_CFG.cardinalities, field_bits=(8, 4, 8, 2))
    dcn = DCNConfig(n_fields=4, emb_dim=8, cross_depth=1, mlp_widths=(16,))
    return CTRTrainer(TrainerConfig(spec=spec, dcn=dcn, lr=1e-3), device="cpu")


@pytest.mark.parametrize("name", ALL_METHODS)
def test_one_train_step_both_formulations(name):
    """Every method takes one step of the unmodified CTRTrainer (its row or
    float-leaf formulation) and one dense-formulation step (the [n, d]
    table's gradient through ``dense_update``, the LM path's)."""
    tr = _trainer(name)
    ids, labels = DATA.batch("train", 0, 16)
    state, m1 = tr.train_step(tr.init_state(), ids, labels)
    assert np.isfinite(float(m1["loss"]))
    method, spec = tr.method, tr.spec
    tids = torch.from_numpy(ids)
    before = method.lookup(tr.init_state().emb_state, tids[:1], spec)
    assert not torch.equal(before, method.lookup(state.emb_state, tids[:1], spec))

    s0 = tr.init_state()
    dense = method.dense_params(s0.emb_state, spec)
    emb = [t.detach().requires_grad_(True) for t in tree_leaves(dense)]
    w = torch.randn(spec.n, spec.d, generator=torch.Generator().manual_seed(1))

    def loss_fn(table):
        return torch.sum(table[tids.long()] * w[tids.long()])

    with torch.enable_grad():
        table = method.dense_table_from(s0.emb_state, tree_like(dense, emb), spec)
        grads = torch.autograd.grad(loss_fn(table), emb)
    g = tree_like(dense, list(grads))
    opt = None if method.is_integer_table else s0.emb_opt
    delta_grad = None
    if method.has_learned_step:
        def delta_grad(w_new, step_vec, gscale):
            return method.dense_delta_grad(w_new, step_vec, loss_fn, spec=spec,
                                           weight_decay=5e-8, gscale=gscale)
    new, _, _ = method.dense_update(
        s0.emb_state, opt, g, spec=spec, lr=1e-2, weight_decay=5e-8,
        noise=method.dense_noise(torch.Generator().manual_seed(2), s0.emb_state, spec),
        delta_grad=delta_grad, batch_rows=tids.numel())
    assert not torch.equal(method.eval_table(new, spec), method.eval_table(s0.emb_state, spec))


def _live_state_equal(m, spec, a, b, ctx):
    """Bitwise on what the model observes: the live table and the dense
    params (a padded table's scratch rows are unspecified on both paths)."""
    assert torch.equal(m.eval_table(a.emb_state, spec), m.eval_table(b.emb_state, spec)), ctx
    for x, y in zip(a.dense.parameters(), b.dense.parameters()):
        assert torch.equal(x, y), f"{ctx}: dense params"


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("name", INT_TABLE_METHODS)
def test_kernel_parity_ctr_sparse(name, pad):
    on, off = _trainer(name, pad=pad), _trainer(name, use_kernels=False, pad=pad)
    s_on, s_off = on.init_state(), off.init_state()
    for step in range(3):
        ids, labels = DATA.batch("train", step, 16)
        s_on, m_on = on.train_step(s_on, ids, labels)
        s_off, m_off = off.train_step(s_off, ids, labels)
        assert float(m_on["loss"]) == float(m_off["loss"]), f"{name} pad={pad} step {step}"
        _live_state_equal(on.method, on.spec, s_on, s_off, f"{name} pad={pad} step {step}")


@pytest.mark.parametrize("name", INT_TABLE_METHODS)
def test_kernel_parity_lm_dense(name):
    """Kernels-on == kernels-off through the LM dense formulation (the vocab
    table's write-back through ``ops.lpt_update`` / ``ops.sr_round``), two
    steps of a one-layer smoke SmolLM."""
    cfg = dataclasses.replace(configs.smoke_config("smollm-135m"), embedding_method=name,
                              n_layers=1)
    rs = np.random.RandomState(0)
    full = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 17)).astype(np.int32))
    batch = {"tokens": full[:, :-1], "labels": full[:, 1:]}
    tables = {}
    for use_kernels in (True, False):
        tcfg = lm_trainer.LMTrainerConfig(lr=1e-3, use_kernels=use_kernels)
        step = lm_trainer.make_train_step(cfg, tcfg)
        state = lm_trainer.init_state(cfg, tcfg, seed=0, device="cpu")
        losses = []
        for _ in range(2):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        tables[use_kernels] = (lm_trainer.table_fp_of(state, cfg, tcfg), losses)
    assert torch.equal(tables[True][0], tables[False][0]), name
    assert tables[True][1] == tables[False][1]


@pytest.mark.parametrize("name", ["qr_lpt", "qr_alpt", "mixed"])
def test_dense_update_matches_reference(name):
    """The composed methods' dense formulation, one step from the reference's
    state with its gradient and SR draws: bitwise on the live rows."""
    kw = dict(method=name, n=N, d=D, bits=8, init_scale=0.05, field_cards=(3, 60, 40),
              field_bits=(8, 4, 2))
    jspec = jmethods.EmbeddingSpec(**kw, use_kernels=False)
    spec = methods.EmbeddingSpec(**kw)
    jm, m = jmethods.get(name), methods.get(name)
    js = jax.jit(lambda k: jm.init(k, jspec))(jax.random.PRNGKey(3))
    state = interop.emb_state_from_numpy(spec, to_np(js), device="cpu")
    rs = np.random.RandomState(1)
    grads = (rs.randn(N, D) * 0.1 * (rs.rand(N, 1) < 0.6)).astype(f32)
    wq = rs.randn(N, D).astype(f32)
    key = jax.random.PRNGKey(5)
    if name == "mixed":
        keys = [jax.random.fold_in(key, g) for g in range(3)]
    elif name == "qr_lpt":
        keys = [jax.random.fold_in(key, g) for g in range(2)]
    else:  # dense_finish draws at fold_in(its key, 1)
        keys = [jax.random.fold_in(jax.random.fold_in(key, g), 1) for g in range(2)]
    subs = js.subs if name == "mixed" else (js.remainder, js.quotient)
    noise = [torch.from_numpy(np.array(jax.random.uniform(k, t.codes.shape, jnp.float32)))
             for k, t in zip(keys, subs)]

    def jdelta(w_new, step_vec, gscale):
        return jm.dense_delta_grad(w_new, step_vec, lambda t: jnp.sum(t * wq), spec=jspec,
                                   weight_decay=5e-8, gscale=gscale)

    jnew = jax.jit(lambda s, g: jm.dense_update(
        s, None, g, spec=jspec, lr=f32(1e-2), weight_decay=5e-8, noise_key=key,
        delta_grad=jdelta, batch_rows=32)[0])(js, jnp.asarray(grads))
    tw = torch.from_numpy(wq)

    def delta(w_new, step_vec, gscale):
        return m.dense_delta_grad(w_new, step_vec, lambda t: torch.sum(t * tw), spec=spec,
                                  weight_decay=5e-8, gscale=gscale)

    new, _, _ = m.dense_update(state, None, torch.from_numpy(grads), spec=spec,
                               lr=float(f32(1e-2)), weight_decay=5e-8, noise=noise,
                               delta_grad=delta, batch_rows=32)
    got, want = interop.emb_state_to_numpy(new), to_np(jnew)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("name", ALL_METHODS)
def test_interop_round_trips_every_state(name):
    """``state_to_numpy`` then ``state_from_numpy`` gives back every tensor of
    a trained state: the table, its Adam state (float leaves), the dense
    params and their Adam state."""
    tr = _trainer(name)
    state = tr.init_state()
    for i in range(2):
        state, _ = tr.train_step(state, *DATA.batch("train", i, 16))
    tree = interop.state_to_numpy(tr.cfg, state)
    back = interop.state_from_numpy(tr.cfg, **tree, device="cpu")
    assert back.step == state.step == 2
    pairs = list(zip(leaves(back.emb_state), leaves(state.emb_state), strict=True))
    pairs += list(zip(back.dense.parameters(), state.dense.parameters(), strict=True))
    for opt_a, opt_b in ((back.dense_opt, state.dense_opt), (back.emb_opt, state.emb_opt)):
        assert (opt_a is None) == (opt_b is None)
        if opt_a is not None:
            assert opt_a.step == opt_b.step
            pairs += list(zip(opt_a.mu + opt_a.nu, opt_b.mu + opt_b.nu, strict=True))
    assert all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.parametrize("argv", [
    ["train", "ctr", "--method", "mixed", "--model", "deepfm", "--steps", "2"],
    ["train", "ctr", "--method", "prune", "--config", "criteo", "--steps", "2"],
    ["serve", "ctr", "--method", "qr_alpt", "--train-steps", "2", "--requests", "40"],
])
def test_clis_take_every_method_model_and_config(argv):
    """The CLIs at ``--scale 0.001`` on the CPU: a finite JSON report, no
    kernel launches (CPU tensors), no fallbacks."""
    import contextlib
    import io
    import json

    from repro_torch.launch import serve, train

    main = {"train": train.main, "serve": serve.main}[argv[0]]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv[1:] + ["--scale", "0.001", "--batch", "16", "--device", "cpu"])
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and report["kernel_launches"] == {}
    if argv[0] == "train":
        assert report["fallbacks"] == [] and all(np.isfinite(report["losses"]))
        assert report["model"] == (argv[argv.index("--model") + 1] if "--model" in argv
                                   else "dcn")
    else:
        assert report["requests_completed"] == 40 and report["int8_resident"]
