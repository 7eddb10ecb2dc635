"""The port's CUDA kernels against their plain versions, on the GPU.

Every test here needs an NVIDIA GPU with ``nvcc`` (they build the kernels
from ``src/repro_torch/kernels/csrc``) and skips without one.  This file
imports neither JAX nor the reference package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import lpt, quant
from repro_torch.core.codestore import CodeStore
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.kernels import adam_update as adam_kernel
from repro_torch.kernels import dequant_gather as gather_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import lpt_update as lpt_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_row_update as row_kernel
from repro_torch.kernels import sr_round as sr_kernel
from repro_torch.core.codestore import pack_codes, unpack_codes
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.methods import EmbeddingSpec
from repro_torch.models import transformer as tfm
from repro_torch.models.ctr import DCNConfig
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.serving.lm import LMEngine, LMRequest
from repro_torch.optim import tree_leaves
from repro_torch.training import lm_trainer
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


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b", [1, 7, 777, 24_576])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [13, 15, 16, 32, 576])
def test_dequant_gather_kernels_bitwise(cuda, d, bits, b, offset):
    # The last row (which ends the table), the first, a repeat and, from 7
    # ids on, ids outside the table, which give NaN rows.  offset 1 moves
    # the codes one byte off their alignment, so the word loads and float4
    # stores cannot be taken.
    g = _gen(bits * d + b + offset, cuda)
    n = 1000
    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=cuda, dtype=torch.int8)
    step = torch.rand(n, generator=g, device=cuda) * 0.1 + 1e-3
    ids = torch.randint(0, n, (b,), generator=g, device=cuda, dtype=torch.int32)
    edge = torch.tensor([n - 1, 0, 3, 3, n, -1, 2 ** 31 - 1], dtype=torch.int32, device=cuda)
    ids[:min(b, 7)] = edge[:min(b, 7)]
    store = CodeStore.from_codes(codes, bits)
    if offset:
        buf = torch.empty(store.data.numel() + offset, dtype=store.data.dtype, device=cuda)
        store = dataclasses.replace(
            store, data=buf[offset:].view(store.data.shape).copy_(store.data))
    ops.reset_kernel_calls()
    got = ops.dequant_gather(store, step, ids)
    torch.cuda.synchronize()
    kernel = "dequant_gather_packed" if store.packed else "dequant_gather"
    assert ops.kernel_calls() == {kernel: 1}
    inside = (ids >= 0) & (ids < n)
    assert got.shape == (b, d) and torch.isnan(got[~inside]).all()
    assert torch.equal(got[inside], ops.dequant_gather(store, step, ids[inside],
                                                       use_kernel=False))
    assert torch.equal(got[inside], ref.dequant_gather_ref(codes, step, ids[inside]))


def test_dequant_gather_out_of_range_ids_give_nan_rows(cuda):
    codes = torch.ones(8, 16, dtype=torch.int8, device=cuda)
    step = torch.ones(8, device=cuda)
    ids = torch.tensor([0, 8, -1, 7], dtype=torch.int32, device=cuda)
    out = gather_kernel.dequant_gather(codes, step, ids)
    torch.cuda.synchronize()
    assert torch.isnan(out[1:3]).all() and torch.equal(out[[0, 3]], torch.ones(2, 16, device=cuda))


def test_gather_wrappers_refuse_more_lane_tasks_than_32_bits_index(cuda):
    # 65 ids of 2^27 columns are 65 * 2^25 lane tasks, past 2^31 - 1.
    codes = torch.zeros(1, 2 ** 27, dtype=torch.int8, device=cuda)
    ids = torch.zeros(65, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="32-bit"):
        gather_kernel.dequant_gather(codes, torch.ones(1, device=cuda), ids)
    assert gather_kernel.dequant_gather(codes, torch.ones(1, device=cuda), ids[:1]).shape == (
        1, 2 ** 27)


def test_stream_of_is_the_current_stream(cuda):
    side = torch.cuda.Stream()
    assert _build.stream_of(cuda) == torch.cuda.current_stream().cuda_stream
    with torch.cuda.stream(side):
        assert _build.stream_of(torch.device("cuda", 0)) == side.cuda_stream
    # The current card needs no device context around a launch.
    here = torch.device("cuda", torch.cuda.current_device())
    assert isinstance(_build.on_device(here), contextlib.nullcontext)


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
        row = "sparse_row_update_runs_packed" if bits < 8 else "sparse_row_update_runs"
        if use_kernels:
            assert launched[row] == 1 and launched.get("sr_round", 0) == (method == "alpt")
            assert "sparse_row_update" not in launched
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


def _runs_operands(g, dev, n_live, d, bits, m, scratch=True, long_run=420):
    """A table (scratch row or none), one wave of m lookups with zipf repeats
    and ``long_run`` lookups of one id, its dedup, runs and row gradients
    (some -0.0)."""
    n = n_live + 8 if scratch else n_live
    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=dev, dtype=torch.int8)
    step = torch.rand(n, generator=g, device=dev) * 0.05 + 1e-3
    mu = torch.randn(n, d, generator=g, device=dev) * 0.01
    nu = torch.rand(n, d, generator=g, device=dev) * 1e-3
    ids = (torch.rand(m, generator=g, device=dev) ** 4 * n_live).to(torch.int32)
    ids[:3] = torch.tensor([0, n_live - 1, 0], device=dev)
    ids[torch.randperm(m - 3, generator=g, device=dev)[:long_run] + 3] = n_live // 2
    uniq, inv, order, starts = lpt.dedup_runs(ids, n_live)
    g_occ = torch.randn(m, d, generator=g, device=dev) * 0.1
    g_occ[torch.rand(m, d, generator=g, device=dev) < 0.02] = -0.0
    noise = torch.rand(m, d, generator=g, device=dev)
    return codes, step, mu, nu, uniq, inv, g_occ, order, starts, noise


def _runs_both(codes, step, mu, nu, uniq, g_occ, order, starts, noise, bits, wd, c1, c2):
    """The runs form, kernel then plain, each on copies of the table:
    [(container, mu, nu, w_new, launches)] * 2."""
    out = []
    for use_kernel in (True, False):
        store = CodeStore.from_codes(codes.clone(), bits)
        m, v = mu.clone(), nu.clone()
        ops.reset_kernel_calls()
        w_new = ops.sparse_row_update_runs(store, step, m, v, uniq, g_occ, order, starts, noise,
                                           0.01, c1, c2, bits, weight_decay=wd,
                                           use_kernel=use_kernel)
        torch.cuda.synchronize()
        out.append((store.data, m, v, w_new, ops.kernel_calls()))
    return out


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [16, 15, 13])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
@pytest.mark.parametrize("scratch", [True, False])
def test_sparse_row_update_runs_kernels_bitwise(cuda, bits, d, weight_decay, scratch):
    """The row step with the gradient sum folded in against its plain twin
    (segment sum in occurrence order, then the row step): live rows and real
    slots bit for bit, with a run of 420 lookups; w_new finite everywhere."""
    g = _gen(100 + bits * d, cuda)
    n_live = 3000
    codes, step, mu, nu, uniq, _, g_occ, order, starts, noise = _runs_operands(
        g, cuda, n_live, d, bits, 4096, scratch)
    c1, c2 = lpt.adam_bias_corrections(9)
    (kc, km, kv, kw, launched), (pc, pm, pv, pw, plain) = _runs_both(
        codes, step, mu, nu, uniq, g_occ, order, starts, noise, bits, weight_decay, c1, c2)
    kernel = "sparse_row_update_runs_packed" if bits < 8 else "sparse_row_update_runs"
    assert launched == {kernel: 1} and plain == {}
    live, real = slice(0, n_live), uniq < n_live
    assert torch.equal(kc[live], pc[live]) and torch.equal(km[live], pm[live])
    assert torch.equal(kv[live], pv[live]) and torch.equal(kw[real], pw[real])
    assert bool(torch.isfinite(kw).all())
    untouched = torch.ones(n_live, dtype=torch.bool, device=cuda)
    untouched[uniq[real].long()] = False
    assert torch.equal(km[:n_live][untouched], mu[:n_live][untouched])


@pytest.mark.parametrize("bits", [8, 4])
def test_sparse_row_update_runs_kernels_bitwise_on_an_avazu_wave(cuda, bits):
    """A real training wave (1,024 Avazu requests: 24,576 lookups, runs up to
    hundreds long) on the full Avazu table, without and with its scratch row."""
    from repro_torch.data.ctr_synth import avazu_like

    data = CTRSynthetic(avazu_like(1.0))
    n_live = data.cfg.n_features
    ids = torch.from_numpy(data.batch("train", 0, 1024)[0].reshape(-1)).to(cuda)
    m, d = ids.numel(), 16
    g = _gen(7 + bits, cuda)
    uniq, inv, order, starts = lpt.dedup_runs(ids, n_live)
    assert int((starts[1:] - starts[:-1]).max()) >= 300
    g_occ = torch.randn(m, d, generator=g, device=cuda) * 0.01
    noise = torch.rand(m, d, generator=g, device=cuda)
    for n in (n_live + 8, n_live):
        lo, hi = quant.code_bounds(bits)
        codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=cuda, dtype=torch.int8)
        step = torch.rand(n, generator=g, device=cuda) * 0.01 + 1e-3
        mu = torch.randn(n, d, generator=g, device=cuda) * 1e-3
        nu = torch.rand(n, d, generator=g, device=cuda) * 1e-5
        (kc, km, kv, kw, _), (pc, pm, pv, pw, _) = _runs_both(
            codes, step, mu, nu, uniq, g_occ, order, starts, noise, bits, 5e-8, 0.1, 0.001)
        real = uniq < n_live
        assert torch.equal(kc[:n_live], pc[:n_live]) and torch.equal(km[:n_live], pm[:n_live])
        assert torch.equal(kv[:n_live], pv[:n_live]) and torch.equal(kw[real], pw[real])
        assert bool(torch.isfinite(kw).all())


def test_sparse_row_update_runs_wrapper_raises_on_bad_operands(cuda):
    g = _gen(3, cuda)
    codes, step, mu, nu, uniq, _, g_occ, order, starts, noise = _runs_operands(
        g, cuda, 100, 16, 8, 256, long_run=40)

    def call(**bad):
        ops_ = dict(g_occ=g_occ, order=order, starts=starts)
        ops_.update(bad)
        row_kernel.sparse_row_update_runs(codes, step, mu, nu, uniq, ops_["g_occ"],
                                          ops_["order"], ops_["starts"], noise, 0.01, 0.1,
                                          0.001, 8)

    with pytest.raises(ValueError, match="order must be torch.int64"):
        call(order=order.int())
    with pytest.raises(ValueError, match="starts must be torch.int32"):
        call(starts=starts.long())
    with pytest.raises(ValueError, match="order must have shape"):
        call(order=order[:-1])
    with pytest.raises(ValueError, match="starts must have shape"):
        call(starts=starts[:-1])
    with pytest.raises(ValueError, match="starts must be a CUDA tensor"):
        call(starts=starts.cpu())
    with pytest.raises(ValueError, match="order must be a CUDA tensor"):
        call(order=order.cpu())
    with pytest.raises(ValueError, match="g_occ must be contiguous"):
        call(g_occ=torch.cat([g_occ, g_occ], 1)[:, :16])
    with pytest.raises(ValueError, match="g_occ must have shape"):
        call(g_occ=g_occ[:, :15].contiguous())
    with pytest.raises(ValueError, match="bits"):
        row_kernel.sparse_row_update_runs_packed(codes.view(torch.uint8), step, mu, nu, uniq,
                                                 g_occ, order, starts, noise, 0.01, 0.1, 0.001,
                                                 8, 16)


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("alpt", 4)])
def test_trainer_without_scratch_row_launches_the_row_kernel_every_step(cuda, method, bits):
    """The paper's setup (pad_to_tiles off): one row-kernel launch (the runs
    form, which sums the gradients itself) and one dense Adam launch per
    step, no fallbacks, and the same state and losses as the plain path."""
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
        row = "sparse_row_update_runs_packed" if bits < 8 else "sparse_row_update_runs"
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


def _head_bound(x, codes, step):
    """(float64 logits, gamma_{K+1} * (|x| @ |w|.T)): the fp32 error bound of
    a K-term sum of rounded products, in any order."""
    k = x.shape[1]
    u = 2.0 ** -24
    w = codes.double() * step.double()[:, None]
    return x.double() @ w.T, (k + 1) * u / (1 - (k + 1) * u) * (x.double().abs() @ w.abs().T)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("m,n,k", [
    (8, 49152, 576), (1, 4099, 576), (3, 37, 13), (3, 37, 15), (70, 300, 130),
    # One n8 tile short, one and one over (passes of x tiles); M = 64 and 65
    # in passes; N not a multiple of the 16-row tile; widths that are not
    # 16-byte aligned (200 int8 and 100 packed bytes); K in three K-blocks.
    (7, 4099, 576), (9, 4099, 576), (64, 4099, 576), (65, 1000, 576), (8, 1000, 200),
    (9, 300, 2560)])
@pytest.mark.parametrize("x_offset", [0, 1])
def test_dequant_matmul_kernels_within_the_fp32_bound(cuda, m, n, k, bits, x_offset):
    g = _gen(m * n + k + bits, cuda)
    lo, hi = quant.code_bounds(bits)
    # x_offset 1: x starts one float into its buffer (not 16-byte aligned).
    x = torch.randn(m * k + x_offset, generator=g, device=cuda)[x_offset:].view(m, k)
    codes = torch.randint(lo, hi + 1, (n, k), generator=g, device=cuda, dtype=torch.int8)
    step = torch.rand(n, generator=g, device=cuda) * 0.01 + 1e-4
    store = CodeStore.from_codes(codes, bits)
    ops.reset_kernel_calls()
    got = ops.dequant_matmul(x, store, step)
    torch.cuda.synchronize()
    kernel = "dequant_matmul_packed" if store.packed else "dequant_matmul"
    assert ops.kernel_calls() == {kernel: 1}
    exact, bound = _head_bound(x, codes, step)
    assert bool(((got.double() - exact).abs() <= bound).all())
    plain = ops.dequant_matmul(x, store, step, use_kernel=False)
    assert bool(((got.double() - plain.double()).abs() <= 2 * bound).all())
    # The packed kernel equals the int8 kernel on the same codes, bitwise,
    # and a row's logits do not depend on the other rows.
    assert torch.equal(got, ops.dequant_matmul(x, codes, step))
    for i in (0, m - 1):
        assert torch.equal(ops.dequant_matmul(x[i:i + 1].contiguous(), store, step), got[i:i + 1])


def test_dequant_matmul_wrappers_raise_on_bad_operands(cuda):
    codes = torch.zeros(8, 16, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.dequant_matmul(torch.zeros(2, 16, device=cuda, dtype=torch.float64), codes,
                           torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        ops.dequant_matmul(torch.zeros(2, 15, device=cuda), codes, torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.dequant_matmul(torch.zeros(16, 2, device=cuda).t(), codes, torch.ones(8, device=cuda))


@pytest.mark.parametrize("b,t,s,h,kh,d,causal,window", [
    (1, 157, 157, 9, 3, 64, True, None), (2, 96, 96, 4, 2, 80, True, 32),
    (1, 64, 64, 4, 4, 128, False, None), (2, 33, 70, 4, 1, 8, False, 7),
    (1, 70, 33, 2, 2, 24, True, 5), (3, 1, 1, 2, 1, 16, True, None),
    # The tiling's edges: a long causal prefill (no kv split); groups of 4
    # and 8 query heads in one block; groups of 16 and 9 split over blocks
    # (8 + 8, 3 + 3 + 3 heads); T not a multiple of the query tile with
    # S > T, non-causal and windowed; a large grid at D = 128, ragged and
    # windowed; kv warp groups that get no tile (T = 100: 4 groups, the
    # first query tile has one kv tile); a window whose footprint starts
    # inside a kv tile, over 3 groups.
    (1, 2048, 2048, 9, 3, 64, True, None), (1, 157, 157, 12, 3, 64, True, None),
    (2, 100, 100, 8, 1, 64, True, None), (1, 50, 50, 16, 1, 32, True, None),
    (1, 40, 40, 9, 1, 16, False, None), (2, 37, 90, 6, 2, 64, False, 20),
    (2, 1031, 1031, 8, 4, 128, True, 100), (1, 100, 100, 3, 1, 64, True, None),
    (1, 157, 157, 9, 3, 64, True, 40)])
def test_flash_attention_kernel_matches_plain(cuda, b, t, s, h, kh, d, causal, window):
    g = _gen(t * d + s, cuda)
    q = torch.randn(b, t, h, d, generator=g, device=cuda)
    k = torch.randn(b, s, kh, d, generator=g, device=cuda)
    v = torch.randn(b, s, kh, d, generator=g, device=cuda)
    ops.reset_kernel_calls()
    got = ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.kernel_calls() == {"flash_attention_fwd": 1}
    want = ops.flash_attention_fwd(q, k, v, causal=causal, window=window, use_kernel=False)
    # exp and sums in another order, online rescaling; outputs are convex
    # combinations of v.
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_flash_attention_wrapper_raises_on_bad_operands(cuda):
    kv = torch.zeros(1, 4, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        flash_kernel.flash_attention_fwd(torch.zeros(1, 4, 2, 64, device=cuda).half(), kv, kv)
    with pytest.raises(ValueError, match="head dim"):
        flash_kernel.flash_attention_fwd(torch.zeros(1, 4, 2, 20, device=cuda),
                                         torch.zeros(1, 4, 1, 20, device=cuda),
                                         torch.zeros(1, 4, 1, 20, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        flash_kernel.flash_attention_fwd(torch.zeros(1, 2, 4, 64, device=cuda).transpose(1, 2),
                                         kv, kv)


@pytest.mark.parametrize("arch,bits", [("smollm-135m", 8), ("smollm-135m", 4),
                                       ("qwen3-1.7b", 8), ("h2o-danube-1.8b", 8)])
def test_lm_engine_kernels_vs_plain_teacher_forced(cuda, arch, bits):
    """Smoke configs on the card: the kernels launch (the head kernel only
    for a tied table: Danube's head is a float matmul), the plain path fed
    the kernel engine's tokens agrees within 1e-4 at every step (another
    summation order in the head, the attention and cuBLAS at batch 1), and
    the requests in reverse order give the same tokens."""
    import dataclasses as dc

    cfg = dc.replace(configs.smoke_config(arch), embedding_bits=bits)
    state = lm_trainer.init_state(cfg, seed=1, device=cuda)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in [(40, 6), (17, 3), (33, 5), (9, 1), (25, 4)]]
    runs = []
    for order in (range(len(reqs)), reversed(range(len(reqs)))):
        engine = LMEngine.from_state(state, cfg, batch=2, max_len=48)
        for i in order:
            engine.submit(LMRequest(prompt=reqs[i][0], max_new=reqs[i][1], rid=i))
        runs.append(engine.run())
        launched = engine.metrics().kernel_launches
        head = "dequant_matmul_packed" if bits < 8 else "dequant_matmul"
        assert (launched.get(head, 0) > 0) == cfg.tie_embeddings
        assert launched.get("flash_attention_fwd") == 5 * cfg.n_layers
    assert runs[0] == runs[1]
    plain = dc.replace(engine.table, use_kernels=False)
    for i, (prompt, _) in enumerate(reqs):
        tokens = runs[0][i]
        p = torch.from_numpy(prompt).to(cuda)[None]
        got, cache = tfm.prefill(state.params, engine.table, p, cfg, 48)
        want, pcache = tfm.prefill(state.params, plain, p, cfg, 48, use_kernel=False)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        for j, tok in enumerate(tokens[:-1]):
            t = torch.tensor([tok], device=cuda)
            got, cache = tfm.decode_step(state.params, engine.table, t, cache, len(prompt) + j,
                                         cfg)
            want, pcache = tfm.decode_step(state.params, plain, t, pcache, len(prompt) + j, cfg,
                                           use_kernel=False)
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# ------------------------------------------------------- LM training slice


@pytest.mark.parametrize("rows,cols", [(4096, 576), (37, 13), (36, 15), (1, 1)])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
@pytest.mark.parametrize("has_new_step", [False, True])
def test_lpt_fused_update_kernels_bitwise(cuda, rows, cols, bits, weight_decay, has_new_step):
    """The write-back kernels against their plain versions, and the packed
    one against pack(int8 kernel(unpack)), on every shape."""
    g = _gen(rows * cols + bits, cuda)
    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (rows, cols), generator=g, device=cuda, dtype=torch.int8)
    step = torch.rand(rows, generator=g, device=cuda) * 0.01 + 1e-3
    upd = torch.randn(rows, cols, generator=g, device=cuda)
    noise = torch.rand(rows, cols, generator=g, device=cuda)
    ns = step * 1.02 if has_new_step else None
    kw = dict(new_step=ns, weight_decay=weight_decay)
    want = ref.lpt_fused_update_ref(codes, step, upd, noise, 3e-3, bits, **kw)
    ops.reset_kernel_calls()
    got = lpt_kernel.lpt_fused_update(codes, step, upd, noise, 3e-3, bits, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if bits < 8:
        packed = pack_codes(codes, bits)
        got_p = lpt_kernel.lpt_fused_update_packed(packed, step, upd, noise, 3e-3, bits, cols, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got_p, ref.lpt_fused_update_packed_ref(packed, step, upd, noise, 3e-3,
                                                                  bits, cols, **kw))
        assert torch.equal(got_p, pack_codes(got, bits))
        assert torch.equal(unpack_codes(got_p, bits, cols), want)
    counts = ops.kernel_calls()
    assert counts.get("lpt_fused_update") == 1
    assert counts.get("lpt_fused_update_packed", 0) == int(bits < 8)


@pytest.mark.parametrize("rows,cols", [(4096, 576), (37, 13), (3, 5), (1, 1)])
@pytest.mark.parametrize("bits", [8, 4])
def test_sr_round_seeded_kernel_bitwise(cuda, rows, cols, bits):
    """Philox in the kernel equals Philox in PyTorch, so the codes are
    bitwise equal to the plain version for several seeds; a seed repeats its
    codes, and every code lies within one lattice step of w / Delta."""
    g = _gen(rows + cols, cuda)
    w = torch.randn(rows, cols, generator=g, device=cuda) * 0.05
    step = quant.init_step_size(w, bits)
    for seed in (0, -1, 12345):
        got = sr_kernel.sr_round_seeded(w, step, seed, bits)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.sr_round_seeded_ref(w, step, seed, bits))
        assert torch.equal(got, sr_kernel.sr_round_seeded(w, step, seed, bits))
        lo, hi = quant.code_bounds(bits)
        exact = torch.clamp(w.double() / step.double()[:, None], lo, hi)
        assert bool(((got.double() - exact).abs() < 1).all())


def test_write_back_wrappers_raise_on_bad_operands(cuda):
    codes = torch.zeros(8, 16, dtype=torch.int8, device=cuda)
    step = torch.ones(8, device=cuda)
    upd = torch.zeros(8, 16, device=cuda)
    with pytest.raises(ValueError, match="noise must have shape"):
        lpt_kernel.lpt_fused_update(codes, step, upd, upd[:4], 0.1, 8)
    with pytest.raises(ValueError, match="codes must be torch.uint8"):
        lpt_kernel.lpt_fused_update_packed(codes, step, upd, upd, 0.1, 4, 16)
    with pytest.raises(ValueError, match="step must be torch.float32"):
        sr_kernel.sr_round_seeded(upd, step.double(), 1, 8)


def test_forward_only_kernels_raise_under_autograd_on_the_card(cuda):
    """A grad-requiring input to a forward-only kernel wrapper raises on the
    card (where the kernel's output would carry no gradient)."""
    codes = torch.zeros(8, 16, dtype=torch.int8, device=cuda)
    step = torch.ones(8, device=cuda, requires_grad=True)
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    x = torch.zeros(2, 16, device=cuda, requires_grad=True)
    q = torch.zeros(1, 4, 2, 64, device=cuda, requires_grad=True)
    kv = torch.zeros(1, 4, 1, 64, device=cuda)
    ops.reset_kernel_calls()
    for call in (lambda: ops.dequant_gather(codes, step, ids),
                 lambda: ops.dequant_matmul(x, codes, step.detach()),
                 lambda: ops.flash_attention_fwd(q, kv, kv)):
        with pytest.raises(RuntimeError, match="forward only"):
            call()
    assert ops.kernel_calls() == {}
    with torch.no_grad():
        ops.dequant_gather(codes, step, ids)
    assert ops.kernel_calls() == {"dequant_gather": 1}


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("lpt", 8), ("lpt", 4)])
def test_lm_train_step_kernels_bitwise_vs_plain(cuda, method, bits):
    """Two smoke LM steps with the kernels on and off from one state: the
    write-back kernel and ``adam_update`` launch once per step, and losses,
    params and table agree bit for bit."""
    cfg = dataclasses.replace(configs.smoke_config("smollm-135m"), embedding_method=method,
                              embedding_bits=bits)
    stream = LMTokenStream(cfg.vocab_size, 64, seed=17)
    batches = [{"tokens": torch.from_numpy(b[:, :-1]).to(cuda),
                "labels": torch.from_numpy(b[:, 1:]).to(cuda)}
               for b in (stream.batch(i, 4) for i in range(2))]
    runs = []
    for use_kernels in (True, False):
        tcfg = lm_trainer.LMTrainerConfig(use_kernels=use_kernels)
        state = lm_trainer.init_state(cfg, tcfg, seed=3, device=cuda)
        step = lm_trainer.make_train_step(cfg, tcfg)
        ops.reset_kernel_calls()
        ops.reset_fallbacks()
        losses = []
        for batch in batches:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        runs.append((state, losses, ops.kernel_calls()))
        assert ops.fallbacks() == []
    (on, on_losses, launches), (off, off_losses, none) = runs
    write_back = {"alpt": "sr_round", "lpt": "lpt_fused_update"}[method]
    if bits < 8:
        write_back += "_packed"
    assert launches == {write_back: 2, "adam_update": 2} and none == {}
    assert on_losses == off_losses
    assert torch.equal(on.table.codes.data, off.table.codes.data)
    for name in ("step", "mu", "nu"):
        assert torch.equal(getattr(on.table, name), getattr(off.table, name)), name
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)
