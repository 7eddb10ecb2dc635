"""The port's CUDA kernels against their plain versions, on the GPU.

Every test here needs an NVIDIA GPU with ``nvcc`` (they build the kernels
from ``src/repro_torch/kernels/csrc``) and skips without one.  This file
imports neither JAX nor the reference package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import lpt, quant
from repro_torch.core.codestore import CodeStore
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.kernels import adam_update as adam_kernel
from repro_torch.kernels import dequant_gather as gather_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_row_update as row_kernel
from repro_torch.methods import EmbeddingSpec
from repro_torch.models.ctr import DCNConfig
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig, clone_state, init_state

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _gen(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("rows,cols", [(4096, 16), (37, 13), (1, 1), (1001, 15)])
def test_sr_round_kernel_bitwise(cuda, rows, cols, bits):
    g = _gen(rows + bits, cuda)
    w = torch.randn(rows, cols, generator=g, device=cuda) * 0.05
    step = quant.init_step_size(w, bits)
    noise = quant.sr_noise(g, (rows, cols))
    ops.reset_kernel_calls()
    got = ops.sr_round(w, step, noise, bits)
    torch.cuda.synchronize()
    assert ops.kernel_calls() == {"sr_round": 1}
    assert torch.equal(got, ref.sr_round_ref(w, step, noise, bits))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [16, 15, 32])
def test_dequant_gather_kernels_bitwise(cuda, bits, d):
    g = _gen(bits * d, cuda)
    n, b = 1000, 777
    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=cuda, dtype=torch.int8)
    step = torch.rand(n, generator=g, device=cuda) * 0.1 + 1e-3
    ids = torch.randint(0, n, (b,), generator=g, device=cuda, dtype=torch.int32)
    ids[:4] = torch.tensor([0, n - 1, 3, 3], device=cuda)
    store = CodeStore.from_codes(codes, bits)
    ops.reset_kernel_calls()
    got = ops.dequant_gather(store, step, ids)
    torch.cuda.synchronize()
    kernel = "dequant_gather_packed" if store.packed else "dequant_gather"
    assert ops.kernel_calls() == {kernel: 1}
    assert torch.equal(got, ops.dequant_gather(store, step, ids, use_kernel=False))
    assert torch.equal(got, ref.dequant_gather_ref(codes, step, ids))


def test_dequant_gather_out_of_range_ids_give_nan_rows(cuda):
    codes = torch.ones(8, 16, dtype=torch.int8, device=cuda)
    step = torch.ones(8, device=cuda)
    ids = torch.tensor([0, 8, -1, 7], dtype=torch.int32, device=cuda)
    out = gather_kernel.dequant_gather(codes, step, ids)
    torch.cuda.synchronize()
    assert torch.isnan(out[1:3]).all() and torch.equal(out[[0, 3]], torch.ones(2, 16, device=cuda))


def test_wrappers_raise_on_bad_operands(cuda):
    codes = torch.zeros(8, 16, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        gather_kernel.dequant_gather(codes, torch.ones(8, device=cuda),
                                     torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        gather_kernel.dequant_gather(torch.zeros(16, 8, dtype=torch.int8, device=cuda).t(),
                                     torch.ones(8, device=cuda),
                                     torch.zeros(4, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("lpt", 4), ("alpt", 2)])
def test_engine_kernels_bitwise_vs_plain(cuda, method, bits):
    data = CTRDatasetConfig(name="t", n_fields=6, cardinalities=(40, 9, 300, 17, 5, 1000))
    spec = EmbeddingSpec(method=method, n=data.n_features, d=16, bits=bits)
    cfg = TrainerConfig(spec=spec, dcn=DCNConfig(n_fields=6, emb_dim=16, cross_depth=2,
                                                 mlp_widths=(64, 32)))
    ops.reset_kernel_calls()
    state = init_state(cfg, device=cuda)
    assert ops.kernel_calls() == {"sr_round": 1}
    ids, _ = CTRSynthetic(data).batch("test", 0, 50)
    results = []
    for use_kernels in (True, False):
        c = dataclasses.replace(cfg, spec=dataclasses.replace(spec, use_kernels=use_kernels))
        engine = CTREngine.from_state(state, c, batch=16)
        rids = [engine.submit(CTRRequest(ids=row)) for row in ids]
        done = engine.run()
        results.append([done[r]["prob"] for r in rids])
        launched = engine.metrics().kernel_launches
        gather = "dequant_gather_packed" if bits < 8 else "dequant_gather"
        assert launched == ({gather: 4} if use_kernels else {})
    assert results[0] == results[1]
    assert all(0.0 < p < 1.0 and np.isfinite(p) for p in results[0])


def _row_operands(g, dev, n_live, d, bits, k):
    """A scratch-row table (rows [n_live, n) dead) and one dedup'd batch."""
    n = n_live + 8
    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=dev, dtype=torch.int8)
    step = torch.rand(n, generator=g, device=dev) * 0.05 + 1e-3
    mu = torch.randn(n, d, generator=g, device=dev) * 0.01
    nu = torch.rand(n, d, generator=g, device=dev) * 1e-3
    ids = (torch.rand(k, generator=g, device=dev) ** 4 * n_live).to(torch.int32)
    ids[:3] = torch.tensor([0, n_live - 1, 0], device=dev)
    uniq, inv = lpt.dedup_ids(ids, n_live)
    g_sum = lpt.segment_sum(torch.randn(k, d, generator=g, device=dev) * 0.1, inv, k)
    noise = torch.rand(k, d, generator=g, device=dev)
    return codes, step, mu, nu, uniq, g_sum, noise


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [16, 15, 13])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
def test_sparse_row_update_kernels_bitwise(cuda, bits, d, weight_decay):
    g = _gen(bits * d, cuda)
    n_live = 3000
    codes, step, mu, nu, uniq, g_sum, noise = _row_operands(g, cuda, n_live, d, bits, 2048)
    c1, c2 = lpt.adam_bias_corrections(9)
    out = []
    for use_kernel in (True, False):
        store = CodeStore.from_codes(codes.clone(), bits)
        m, v = mu.clone(), nu.clone()
        ops.reset_kernel_calls()
        w_new = ops.sparse_row_update(store, step, m, v, uniq, g_sum, noise, 0.01, c1, c2, bits,
                                      weight_decay=weight_decay, use_kernel=use_kernel)
        torch.cuda.synchronize()
        kernel = "sparse_row_update_packed" if store.packed else "sparse_row_update"
        assert ops.kernel_calls() == ({kernel: 1} if use_kernel else {})
        out.append((store.data, m, v, w_new))
    (kc, km, kv, kw), (pc, pm, pv, pw) = out
    live, real = slice(0, n_live), uniq < n_live
    assert torch.equal(kc[live], pc[live]) and torch.equal(km[live], pm[live])
    assert torch.equal(kv[live], pv[live]) and torch.equal(kw[real], pw[real])
    untouched = torch.ones(n_live, dtype=torch.bool, device=cuda)
    untouched[uniq[real].long()] = False
    assert torch.equal(km[:n_live][untouched], mu[:n_live][untouched])


def test_sparse_row_update_wrapper_raises_on_bad_operands(cuda):
    g = _gen(1, cuda)
    codes, step, mu, nu, uniq, g_sum, noise = _row_operands(g, cuda, 100, 16, 8, 64)
    args = (step, mu, nu, uniq, g_sum, noise, 0.01, 0.1, 0.001, 8)
    with pytest.raises(ValueError, match="int32"):
        row_kernel.sparse_row_update(codes, step, mu, nu, uniq.long(), *args[4:])
    with pytest.raises(ValueError, match="contiguous"):
        row_kernel.sparse_row_update(codes, step, mu.t().contiguous().t(), *args[2:])
    with pytest.raises(ValueError, match="shape"):
        row_kernel.sparse_row_update(codes, step, mu, nu, uniq, g_sum[:10], *args[5:])
    with pytest.raises(ValueError, match="CUDA"):
        row_kernel.sparse_row_update(codes, step.cpu(), *args[1:])
    with pytest.raises(ValueError, match="bits"):
        row_kernel.sparse_row_update_packed(codes.view(torch.uint8), *args[:-1], 8, 16)


def test_segment_sum_deterministic_and_in_occurrence_order(cuda):
    g = _gen(2, cuda)
    ids = (torch.rand(24576, generator=g, device=cuda) ** 8 * 5000).to(torch.int32)
    vals = torch.randn(24576, 16, generator=g, device=cuda) * torch.rand(24576, 1, generator=g,
                                                                          device=cuda) * 100
    _, inv = lpt.dedup_ids(ids, 5000)
    a = lpt.segment_sum(vals, inv, 24576)
    b = lpt.segment_sum(vals, inv, 24576)
    want = lpt.segment_sum(vals.cpu(), inv.cpu(), 24576)  # index_add_: in order
    assert torch.equal(a, b) and torch.equal(a.cpu(), want)


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("alpt", 4), ("lpt", 2)])
def test_trainer_step_kernels_bitwise_vs_plain(cuda, method, bits):
    data = CTRDatasetConfig(name="t", n_fields=6, cardinalities=(40, 9, 300, 17, 5, 1000))
    spec = EmbeddingSpec(method=method, n=data.n_features, d=16, bits=bits, pad_to_tiles=True,
                         clip_value=0.1 if method == "lpt" else None)
    cfg = TrainerConfig(spec=spec, dcn=DCNConfig(n_fields=6, emb_dim=16, cross_depth=2,
                                                 mlp_widths=(64, 32)))
    state0 = init_state(cfg, device=cuda)
    ids, labels = CTRSynthetic(data).batch("train", 0, 128)
    results = []
    for use_kernels in (True, False):
        c = dataclasses.replace(cfg, spec=dataclasses.replace(spec, use_kernels=use_kernels))
        ops.reset_kernel_calls()
        ops.reset_fallbacks()
        state, m = CTRTrainer(c, device=cuda).train_step(clone_state(state0), ids, labels)
        torch.cuda.synchronize()
        launched = ops.kernel_calls()
        row = "sparse_row_update_packed" if bits < 8 else "sparse_row_update"
        if use_kernels:
            assert launched[row] == 1 and launched.get("sr_round", 0) == (method == "alpt")
            assert ops.fallbacks() == []
        else:
            assert launched == {}
        results.append((state, float(m["loss"])))
    (a, la), (b, lb) = results
    assert la == lb and np.isfinite(la)
    n = spec.n
    for x, y in ((a.emb_state.codes.data, b.emb_state.codes.data),
                 (a.emb_state.step, b.emb_state.step), (a.emb_state.mu, b.emb_state.mu),
                 (a.emb_state.nu, b.emb_state.nu)):
        assert torch.equal(x[:n], y[:n])


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_sparse_row_update_kernels_drop_a_sentinel_past_the_table(cuda, bits):
    """No scratch row: the sentinel id n lies past the table.  Its slots
    write nothing and get finite rows; live rows and real slots equal the
    plain version's bit for bit, row n - 1 (in the wave) included."""
    g = _gen(50 + bits, cuda)
    n_live = 3000
    codes, step, mu, nu, uniq, g_sum, noise = _row_operands(g, cuda, n_live, 16, bits, 2048)
    codes, step, mu, nu = codes[:n_live], step[:n_live], mu[:n_live], nu[:n_live]
    assert bool((uniq == n_live).any()) and bool((uniq == n_live - 1).any())
    out = []
    for use_kernel in (True, False):
        store = CodeStore.from_codes(codes.clone(), bits)
        m, v = mu.clone(), nu.clone()
        ops.reset_kernel_calls()
        w_new = ops.sparse_row_update(store, step, m, v, uniq, g_sum, noise, 0.01, 0.1, 0.001,
                                      bits, weight_decay=5e-8, use_kernel=use_kernel)
        torch.cuda.synchronize()
        assert sum(ops.kernel_calls().values()) == int(use_kernel)
        out.append((store.data, m, v, w_new))
    (kc, km, kv, kw), (pc, pm, pv, pw) = out
    real = uniq < n_live
    assert torch.equal(kc, pc) and torch.equal(km, pm) and torch.equal(kv, pv)
    assert torch.equal(kw[real], pw[real]) and bool(torch.isfinite(kw).all())


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("alpt", 4)])
def test_trainer_without_scratch_row_launches_the_row_kernel_every_step(cuda, method, bits):
    """The paper's setup (pad_to_tiles off): one row-kernel launch and one
    dense Adam launch per step, no fallbacks, and the same state and losses
    as the plain path."""
    data = CTRDatasetConfig(name="t", n_fields=6, cardinalities=(40, 9, 300, 17, 5, 1000))
    spec = EmbeddingSpec(method=method, n=data.n_features, d=16, bits=bits)
    assert spec.n_padded == spec.n
    cfg = TrainerConfig(spec=spec, dcn=DCNConfig(n_fields=6, emb_dim=16, cross_depth=2,
                                                 mlp_widths=(64, 32)))
    state0 = init_state(cfg, device=cuda)
    synth = CTRSynthetic(data)
    results = []
    for use_kernels in (True, False):
        c = dataclasses.replace(cfg, spec=dataclasses.replace(spec, use_kernels=use_kernels))
        ops.reset_kernel_calls()
        ops.reset_fallbacks()
        state, history = CTRTrainer(c, device=cuda).fit(synth, steps=3, batch_size=128,
                                                        state=clone_state(state0))
        launched = ops.kernel_calls()
        row = "sparse_row_update_packed" if bits < 8 else "sparse_row_update"
        if use_kernels:
            assert launched[row] == 3 and launched["adam_update"] == 3
        else:
            assert launched == {}
        assert ops.fallbacks() == []
        results.append((state, [h["loss"] for h in history]))
    (a, la), (b, lb) = results
    assert la == lb and all(np.isfinite(la))
    for x, y in ((a.emb_state.codes.data, b.emb_state.codes.data),
                 (a.emb_state.step, b.emb_state.step), (a.emb_state.mu, b.emb_state.mu),
                 (a.emb_state.nu, b.emb_state.nu)):
        assert torch.equal(x, y)
    assert all(torch.equal(p, q) for p, q in zip(a.dense.parameters(), b.dense.parameters()))


@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
def test_adam_update_kernel_bitwise(cuda, weight_decay):
    g = _gen(7, cuda)
    # More tensors than one launch takes, of uneven sizes (one empty).
    shapes = [(384, 384), (384,), (1,), (0,), (1000, 3), (7, 5)] * 5
    params = [torch.randn(s, generator=g, device=cuda) for s in shapes]
    grads = [torch.randn(s, generator=g, device=cuda) * 1e-2 for s in shapes]
    mu = [torch.randn(s, generator=g, device=cuda) * 1e-3 for s in shapes]
    nu = [torch.rand(s, generator=g, device=cuda) * 1e-5 for s in shapes]
    before = [p.clone() for p in params]
    bc1, bc2 = lpt.adam_bias_corrections(5)
    ops.reset_kernel_calls()
    got = ops.adam_update(params, grads, mu, nu, 3e-3, bc1, bc2, weight_decay=weight_decay)
    torch.cuda.synchronize()
    assert ops.kernel_calls() == {"adam_update": 1}
    want = ref.adam_update_ref(params, grads, mu, nu, 3e-3, bc1, bc2, weight_decay=weight_decay)
    for got_list, want_list in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(got_list, want_list))
    assert all(torch.equal(p, q) for p, q in zip(params, before))  # out of place


def test_adam_update_wrapper_raises_on_bad_operands(cuda):
    p = [torch.zeros(4, 3, device=cuda)]
    z = [torch.zeros(4, 3, device=cuda)]
    with pytest.raises(ValueError, match="grads"):
        adam_kernel.adam_update(p, [], z, z, 1e-3, 0.1, 0.001)
    with pytest.raises(ValueError, match="shape"):
        adam_kernel.adam_update(p, [torch.zeros(3, 4, device=cuda)], z, z, 1e-3, 0.1, 0.001)
    with pytest.raises(ValueError, match="float32"):
        adam_kernel.adam_update(p, [z[0].double()], z, z, 1e-3, 0.1, 0.001)
    with pytest.raises(ValueError, match="contiguous"):
        adam_kernel.adam_update([torch.zeros(3, 4, device=cuda).t()], z, z, z, 1e-3, 0.1, 0.001)
    with pytest.raises(ValueError, match="CUDA"):
        adam_kernel.adam_update(p, [z[0].cpu()], z, z, 1e-3, 0.1, 0.001)
