"""The port's CUDA kernels against their plain versions, on the GPU.

Every test here needs an NVIDIA GPU with ``nvcc`` (they build the kernels
from ``src/repro_torch/kernels/csrc``) and skips without one.  This file
imports neither JAX nor the reference package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import collections
import contextlib
import dataclasses
import time

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


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_gather_kernels_bitwise_at_the_vlm_width(cuda, bits):
    """qwen2-vl-7b's vocab table, 152,064 x 3,584 (896 four-byte lane tasks a
    row at 8 bits): a decode step's, a prefill's and a training batch's
    token ids, the first and last rows among them, bitwise the plain
    version."""
    g = _gen(3584 + bits, cuda)
    n, d = 152_064, 3_584
    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=cuda, dtype=torch.int8)
    step = torch.rand(n, generator=g, device=cuda) * 0.1 + 1e-3
    store = CodeStore.from_codes(codes, bits)
    del codes
    kernel = "dequant_gather_packed" if store.packed else "dequant_gather"
    for b in (8, 256, 4 * 1024):
        ids = torch.randint(0, n, (b,), generator=g, device=cuda, dtype=torch.int32)
        ids[:2] = torch.tensor([n - 1, 0], device=cuda)
        ops.reset_kernel_calls()
        got = ops.dequant_gather(store, step, ids)
        torch.cuda.synchronize()
        assert ops.kernel_calls() == {kernel: 1}
        assert torch.equal(got, ops.dequant_gather(store, step, ids, use_kernel=False)), b


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
    # In place (a donated LM step): the kernel and its plain version each
    # overwrite their own copies with the same values.
    copies = [[[t.clone() for t in ts] for ts in (params, mu, nu)] for _ in range(2)]
    ops.reset_kernel_calls()
    for (p_, m_, v_), use_kernel in zip(copies, (True, False)):
        out = ops.adam_update(p_, grads, m_, v_, 3e-3, bc1, bc2, weight_decay=weight_decay,
                              use_kernel=use_kernel, inplace=True)
        assert all(o is t for o, t in zip(out[1] + out[2], m_ + v_))
        assert all(o.data_ptr() == t.data_ptr() for o, t in zip(out[0], p_))
    torch.cuda.synchronize()
    assert ops.kernel_calls() == {"adam_update": 1}
    for got_list, *copied in zip(want, *copies):
        for y, a, b in zip(got_list, *copied):
            assert torch.equal(a, y) and torch.equal(b, y)


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
    (1, 157, 157, 9, 3, 64, True, 40),
    # qwen2-vl-7b's prefill: 28/4 heads at D = 128, a group of 7 in one block.
    (1, 64, 64, 28, 4, 128, True, None), (1, 157, 157, 28, 4, 128, True, None),
    (2, 256, 256, 28, 4, 128, True, None),
    # deepseek-67b's prefill: 64/8 heads at D = 128, a group of 8 in one block.
    (1, 64, 64, 64, 8, 128, True, None), (1, 100, 100, 64, 8, 128, True, None),
    (2, 256, 256, 64, 8, 128, True, None)])
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
                                       ("qwen3-1.7b", 8), ("h2o-danube-1.8b", 8),
                                       ("mamba2-370m", 8), ("mamba2-370m", 4),
                                       ("deepseek-moe-16b", 8), ("mixtral-8x7b", 8),
                                       ("jamba-v0.1-52b", 8), ("qwen2-vl-7b", 8),
                                       ("qwen2-vl-7b", 4)])
def test_lm_engine_kernels_vs_plain_teacher_forced(cuda, arch, bits):
    """Smoke configs on the card: the kernels launch (the head kernel only
    for a tied table: Danube's and the MoE stacks' heads are float matmuls;
    flash once per attention layer and request, never for mamba2), the
    plain path fed the kernel engine's tokens agrees within 1e-4 at every
    step (another summation order in the head, the attention and cuBLAS at
    batch 1), and the requests in reverse order give the same tokens.  An
    SSM stack's prompts are at most one chunk (32) or a multiple of it."""
    import dataclasses as dc

    cfg = dc.replace(configs.smoke_config(arch), embedding_bits=bits)
    state = lm_trainer.init_state(cfg, seed=1, device=cuda)
    rng = np.random.RandomState(0)
    lens = [(32, 6), (17, 3), (24, 5), (9, 1), (25, 4)] if cfg.ssm else [
        (40, 6), (17, 3), (33, 5), (9, 1), (25, 4)]
    reqs = [(rng.randint(0, cfg.vocab_size, n).astype(np.int32), m) for n, m in lens]
    attn_layers = cfg.n_groups * cfg.layer_types.count("attn")
    runs = []
    for order in (range(len(reqs)), reversed(range(len(reqs)))):
        engine = LMEngine.from_state(state, cfg, batch=2, max_len=48)
        for i in order:
            engine.submit(LMRequest(prompt=reqs[i][0], max_new=reqs[i][1], rid=i))
        runs.append(engine.run())
        launched = engine.metrics().kernel_launches
        head = "dequant_matmul_packed" if bits < 8 else "dequant_matmul"
        assert (launched.get(head, 0) > 0) == cfg.tie_embeddings
        assert launched.get("flash_attention_fwd", 0) == 5 * attn_layers
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


def _vlm_positions(b: int, t: int, rows: int, cols: int, device) -> torch.Tensor:
    """Grid M-RoPE positions [3, b, t]: the prefix a ``rows`` x ``cols`` patch
    grid (temporal 0, height = row, width = col), the text after it equal in
    all three streams from the prefix's largest position + 1 on."""
    p = rows * cols
    pos = torch.zeros(3, t, dtype=torch.int32)
    pos[1, :p] = torch.arange(rows).repeat_interleave(cols)
    pos[2, :p] = torch.arange(cols).repeat(rows)
    pos[:, p:] = max(rows, cols) + torch.arange(t - p)
    return pos[:, None].expand(3, b, t).contiguous().to(device)


def test_vlm_width_alpt_step_kernels_bitwise_vs_plain(cuda):
    """qwen2-vl-7b at full width with one layer (d = 3,584, 28/4 heads with
    QKV bias, the untied head, the 152,064-row ALPT-8 table): two steps of
    a mixed batch (a 256-position visual prefix, grid M-RoPE positions) with
    the kernels on and off from one seed: ``sr_round`` and ``adam_update``
    launch once per step, and losses, gradient norms, params, Adam moments
    and the table agree bit for bit."""
    cfg = configs.full_config("qwen2-vl-7b", n_layers=1)
    b, t = 1, 512
    stream = LMTokenStream(cfg.vocab_size, t, seed=17)
    g = _gen(7, cuda)
    batches = []
    for i in range(2):
        full = torch.from_numpy(stream.batch(i, b)).to(cuda)
        batches.append({"tokens": full[:, :-1], "labels": full[:, 1:],
                        "prefix_embeds": torch.randn(b, cfg.visual_prefix, cfg.d_model,
                                                     generator=g, device=cuda),
                        "positions": _vlm_positions(b, t, 16, 16, cuda)})
    runs = []
    for use_kernels in (True, False):
        tcfg = lm_trainer.LMTrainerConfig(use_kernels=use_kernels)
        state = lm_trainer.init_state(cfg, tcfg, seed=3, device=cuda)
        step = lm_trainer.make_train_step(cfg, tcfg)
        ops.reset_kernel_calls()
        ops.reset_fallbacks()
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["step_grad_norm"])))
        runs.append((state, metrics, ops.kernel_calls()))
        assert ops.fallbacks() == []
    (on, on_metrics, launches), (off, off_metrics, none) = runs
    assert launches == {"sr_round": 2, "adam_update": 2} and none == {}
    assert on_metrics == off_metrics and all(np.isfinite(on_metrics).ravel())
    assert torch.equal(on.table.codes.data, off.table.codes.data)
    for name in ("step", "mu", "nu"):
        assert torch.equal(getattr(on.table, name), getattr(off.table, name)), name
    for a, b_ in zip(tree_leaves(on.params) + on.opt.mu + on.opt.nu,
                     tree_leaves(off.params) + off.opt.mu + off.opt.nu):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("lpt", 4)])
def test_mamba2_train_step_kernels_bitwise_vs_plain(cuda, method, bits):
    """mamba2's smoke config (4 mamba layers, tied head): two steps with the
    kernels on and off from one state: the write-back and ``adam_update``
    launch once per step, and losses, gradient norms, params, Adam moments
    and table agree bit for bit (the SSD, the conv and the projections are
    the same PyTorch on both sides)."""
    cfg = dataclasses.replace(configs.smoke_config("mamba2-370m"), embedding_method=method,
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
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((state, metrics, ops.kernel_calls()))
        assert ops.fallbacks() == []
    (on, on_metrics, launches), (off, off_metrics, none) = runs
    write_back = "sr_round" if method == "alpt" else "lpt_fused_update_packed"
    assert launches == {write_back: 2, "adam_update": 2} and none == {}
    assert on_metrics == off_metrics and all(np.isfinite(on_metrics).ravel())
    assert torch.equal(on.table.codes.data, off.table.codes.data)
    for name in ("step", "mu", "nu"):
        assert torch.equal(getattr(on.table, name), getattr(off.table, name)), name
    for a, b in zip(tree_leaves(on.params) + on.opt.mu + on.opt.nu,
                    tree_leaves(off.params) + off.opt.mu + off.opt.nu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("lpt", 4)])
def test_encoder_train_step_kernels_bitwise_vs_plain(cuda, method, bits):
    """hubert's smoke config (frames in, the gelu MLP, non-causal attention,
    an untied head, so the loss reads no table): two steps with the kernels
    on and off from one state: the write-back and ``adam_update`` launch
    once per step, and losses, gradient norms, params, Adam moments and the
    table (which a zero gradient leaves as it was) agree bit for bit."""
    from repro_torch.launch.train import lm_batch

    cfg = dataclasses.replace(configs.smoke_config("hubert-xlarge"), embedding_method=method,
                              embedding_bits=bits)
    stream = LMTokenStream(cfg.vocab_size, 64, seed=17)
    batches = [lm_batch(cfg, stream, i, 4, 64, cuda) for i in range(2)]
    runs = []
    for use_kernels in (True, False):
        tcfg = lm_trainer.LMTrainerConfig(use_kernels=use_kernels)
        state = lm_trainer.init_state(cfg, tcfg, seed=3, device=cuda)
        codes0 = state.table.codes.data.clone()
        step = lm_trainer.make_train_step(cfg, tcfg)
        ops.reset_kernel_calls()
        ops.reset_fallbacks()
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((state, metrics, ops.kernel_calls()))
        assert ops.fallbacks() == [] and torch.equal(state.table.codes.data, codes0)
    (on, on_metrics, launches), (off, off_metrics, none) = runs
    write_back = "sr_round" if method == "alpt" else "lpt_fused_update_packed"
    assert launches == {write_back: 2, "adam_update": 2} and none == {}
    assert on_metrics == off_metrics and all(np.isfinite(on_metrics).ravel())
    for name in ("step", "mu", "nu"):
        assert torch.equal(getattr(on.table, name), getattr(off.table, name)), name
    for a, b in zip(tree_leaves(on.params) + on.opt.mu + on.opt.nu,
                    tree_leaves(off.params) + off.opt.mu + off.opt.nu):
        assert torch.equal(a, b)


def test_remat_train_step_bitwise_vs_without_on_the_card(cuda):
    """deepseek-67b's smoke config (remat per group) on the card, kernels on:
    two ALPT-8 steps with remat on and off, and with remat on and the state
    donated (the in-place Adam kernel), from one seed give the same losses,
    params, Adam moments and table bit for bit, with the same launches."""
    stream = LMTokenStream(512, 64, seed=17)
    batches = [{"tokens": torch.from_numpy(b[:, :-1]).to(cuda),
                "labels": torch.from_numpy(b[:, 1:]).to(cuda)}
               for b in (stream.batch(i, 4) for i in range(2))]
    runs = []
    for remat, donate in ((True, False), (False, False), (True, True)):
        cfg = dataclasses.replace(configs.smoke_config("deepseek-67b"), remat=remat)
        tcfg = lm_trainer.LMTrainerConfig()
        state = lm_trainer.init_state(cfg, tcfg, seed=3, device=cuda)
        step = lm_trainer.make_train_step(cfg, tcfg, donate=donate)
        ops.reset_kernel_calls()
        losses = []
        for batch in batches:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        t = state.table
        runs.append((losses, ops.kernel_calls(), [*tree_leaves(state.params), *state.opt.mu,
                                                  *state.opt.nu, t.codes.data, t.step, t.mu,
                                                  t.nu]))
    (on_losses, on_launches, on), *others = runs
    assert on_launches == {"sr_round": 2, "adam_update": 2} and all(np.isfinite(on_losses))
    for losses, launches, leaves in others:
        assert launches == on_launches and losses == on_losses
        assert all(torch.equal(a, b) for a, b in zip(on, leaves))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("on_scratch", [False, True])
def test_sparse_row_update_runs_kernels_bitwise_with_a_21500_long_run(cuda, bits, on_scratch):
    """A wave of 24,576 lookups, 21,500 of them one id: a live row (as a qr_*
    remainder row at r = 2 takes ~12,288) or the scratch row, where mixed's
    sentinel run lands on a padded group.  Live rows and the slots with a
    run bit for bit, the run summed in occurrence order."""
    g = _gen(200 + bits, cuda)
    n_live, m, d, long_run = 3000, 24_576, 16, 21_500
    codes, step, mu, nu, uniq, _, g_occ, order, starts, noise = _runs_operands(
        g, cuda, n_live, d, bits, m, long_run=long_run)
    if on_scratch:  # the long run's id becomes the sentinel: the scratch row
        ids = torch.empty(m, dtype=torch.int32, device=cuda)
        ids[order] = torch.repeat_interleave(uniq, (starts[1:] - starts[:-1]).long())
        ids[ids == n_live // 2] = n_live
        uniq, _, order, starts = lpt.dedup_runs(ids, n_live)
    runs = starts[1:] - starts[:-1]
    assert int(runs.max()) >= long_run
    (kc, km, kv, kw, launched), (pc, pm, pv, pw, _) = _runs_both(
        codes, step, mu, nu, uniq, g_occ, order, starts, noise, bits, 5e-8, 0.1, 0.001)
    assert sum(launched.values()) == 1
    live, ran = slice(0, n_live), runs > 0
    assert torch.equal(kc[live], pc[live]) and torch.equal(km[live], pm[live])
    assert torch.equal(kv[live], pv[live]) and torch.equal(kw[ran], pw[ran])
    assert bool(torch.isfinite(kw).all())


def _small_ctr(method, *, model="dcn", dropout=0.0, pad=True, use_kernels=True):
    data = CTRDatasetConfig(name="t", n_fields=6, cardinalities=(40, 9, 300, 17, 5, 5000))
    d = 16 + (model == "deepfm")
    from repro_torch.models.ctr import DeepFMConfig

    spec = EmbeddingSpec(method=method, n=data.n_features, d=d, bits=8, pad_to_tiles=pad,
                         use_kernels=use_kernels, field_cards=data.cardinalities)
    cfg = TrainerConfig(spec=spec, model=model,
                        dcn=DCNConfig(n_fields=6, emb_dim=16, cross_depth=2, mlp_widths=(64, 32),
                                      dropout=dropout),
                        deepfm=DeepFMConfig(n_fields=6, emb_dim=16, mlp_widths=(64, 32),
                                            dropout=dropout))
    return CTRSynthetic(data), cfg


@pytest.mark.parametrize("method,model,dropout", [
    ("mixed", "dcn", 0.0), ("qr_lpt", "dcn", 0.0), ("qr_alpt", "dcn", 0.0),
    ("lsq", "dcn", 0.0), ("pact", "dcn", 0.0), ("hash", "dcn", 0.0), ("prune", "dcn", 0.0),
    ("alpt", "deepfm", 0.0), ("alpt", "dcn", 0.2)])
def test_every_method_trains_and_serves_kernels_vs_plain(cuda, method, model, dropout):
    """3 steps kernels on and off from one initial state (the same dropout
    draws): bitwise state and losses, the composed methods' kernels
    launched, nothing falling back; then the trained state served through
    CTREngine, bitwise against the plain gathers."""
    synth, cfg = _small_ctr(method, model=model, dropout=dropout)
    state0 = init_state(cfg, device=cuda)
    runs = []
    for use_kernels in (True, False):
        c = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec, use_kernels=use_kernels))
        ops.reset_kernel_calls()
        ops.reset_fallbacks()
        state, history = CTRTrainer(c, device=cuda).fit(synth, steps=3, batch_size=128,
                                                        state=clone_state(state0))
        torch.cuda.synchronize()
        runs.append((state, [h["loss"] for h in history], ops.kernel_calls(), c))
        assert ops.fallbacks() == []
    (a, la, launched, c_on), (b, lb, plain, c_off) = runs
    assert la == lb and all(np.isfinite(la)) and plain == {}
    assert launched["adam_update"] == 3 * (1 + (not cfg.spec.is_integer_table))
    if method == "mixed":  # groups at 8, 4 and 2 bits
        assert launched["sparse_row_update_runs"] == 3
        assert launched["sparse_row_update_runs_packed"] == 6
    if method.startswith("qr_"):
        assert launched["sparse_row_update_runs"] == 6
        assert launched.get("sr_round", 0) == 6 * (method == "qr_alpt")
    for x, y in zip(_live(a.emb_state, cfg.spec), _live(b.emb_state, cfg.spec), strict=True):
        assert torch.equal(x, y)
    assert all(torch.equal(p, q) for p, q in zip(a.dense.parameters(), b.dense.parameters()))
    ids, _ = synth.batch("test", 0, 200)
    served = []
    for c in (c_on, c_off):
        engine = CTREngine.from_state(a, c, batch=64)
        rids = [engine.submit(CTRRequest(ids=r)) for r in ids]
        done = engine.run()
        served.append([done[r]["logit"] for r in rids])
    assert served[0] == served[1] and all(np.isfinite(served[0]))


def _live(state, spec):
    """A table state's tensors over its live rows: each LPT sub-table's
    codes, Delta and slots up to its id space (a padded table's scratch row
    takes the sentinel runs and is unspecified), every float leaf whole."""
    from repro_torch.core.hashing import qr_rows
    from repro_torch.methods.mixed import plan_of

    if spec.method in ("qr_lpt", "qr_alpt"):
        tables = zip((state.remainder, state.quotient), qr_rows(spec.n))
    elif spec.method == "mixed":
        tables = zip(state.subs, plan_of(spec).group_rows)
    elif isinstance(state, lpt.LPTTable):
        tables = [(state, spec.n)]
    else:
        return [v for v in state if isinstance(v, torch.Tensor)]
    return [t[:n] for table, n in tables for t in (table.codes.data, table.step, table.mu,
                                                     table.nu)]


@pytest.mark.parametrize("model,dropout", [("dcn", 0.0), ("dcn", 0.2)])
def test_ctr_resume_on_the_card_is_bitwise(cuda, tmp_path, model, dropout):
    """ALPT-8: 6 steps straight on the card against 3 steps, a save through
    ``CheckpointManager`` (tensors copied off the card), a fresh trainer's
    restore onto the card and 3 more: the same losses, table, dense params,
    optimizer state and generator state, bit for bit; the kernels launch
    on both halves."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.training.ctr_trainer import checkpoint_tree

    synth, cfg = _small_ctr("alpt", model=model, dropout=dropout)
    trainer = CTRTrainer(cfg, device=cuda)
    straight, h_straight = trainer.fit(synth, steps=6, batch_size=128)
    manager = CheckpointManager(tmp_path)
    state, h1 = trainer.fit(synth, steps=3, batch_size=128)
    assert trainer.save(manager, state, force=True)
    del state
    torch.cuda.empty_cache()
    ops.reset_kernel_calls()
    fresh = CTRTrainer(cfg, device=cuda)
    state = fresh.restore(manager)
    assert state.emb_state.codes.data.is_cuda and state.emb_state.codes.data.dtype == torch.int8
    state, h2 = fresh.fit(synth, steps=3, batch_size=128, state=state)
    torch.cuda.synchronize()
    assert ops.kernel_calls()["sparse_row_update_runs"] == 3
    assert [h["loss"] for h in h1 + h2] == [h["loss"] for h in h_straight]
    for (p, a), (q, b) in zip(ckpt.flatten(checkpoint_tree(cfg, state)),
                              ckpt.flatten(checkpoint_tree(cfg, straight)),
                              strict=True):
        assert p == q
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.detach().cpu(), b.detach().cpu()), p
        else:
            assert a == b, p


# ------------------------------------------------------------------ storage tiers


def _tiered_table(g, dev, n, d, bits, cap, cached_ids, *, consistent=True):
    """A CodeStore [n, d] behind a hot tier of ``cap`` rows holding
    ``cached_ids`` (their backing rows, or with ``consistent=False`` other
    codes, so a wrong route shows)."""
    from repro_torch.storage.tiered import HotRowCache

    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=dev, dtype=torch.int8)
    cache = HotRowCache(cap, n)
    tiered = cache.observe_apply(cache.wrap(CodeStore.from_codes(codes, bits)),
                                 cached_ids.cpu().numpy())
    if not consistent:
        other = torch.randint(lo, hi + 1, (cap, d), generator=g, device=dev, dtype=torch.int8)
        tiered.hot.data.copy_(CodeStore.from_codes(other, bits).data)
    return tiered


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [13, 15, 16])
def test_routed_gathers_bitwise(cuda, d, bits, staged):
    """The routed gathers (through the map, and staged as the cold tier
    reads) against their plain versions, bitwise, with hot rows that differ
    from the backing; with a consistent hot tier, equal to the untiered
    gather over the logical table."""
    g = _gen(500 + d * bits + staged, cuda)
    n, b = 1000, 777
    ids = (torch.rand(b, generator=g, device=cuda) ** 3 * n).to(torch.int32)
    ids[:2] = torch.tensor([n - 1, 0], dtype=torch.int32, device=cuda)
    step = torch.rand(n, generator=g, device=cuda) * 0.1 + 1e-3
    kernel = "dequant_gather_packed_routed" if bits < 8 else "dequant_gather_routed"
    for consistent in (False, True):
        tiered = _tiered_table(g, cuda, n, d, bits, 64, torch.unique(ids)[::2], consistent=consistent)
        if staged:  # as the cold tier stages: the distinct uncached rows
            slot = tiered.slot_of_id[ids.long()]
            miss = slot < 0
            need, inv = torch.unique(ids[miss], return_inverse=True)
            slot[miss] = (-1 - inv).to(torch.int32)
            args = (tiered.backing.data[need.long()].contiguous(), tiered.hot.data, slot, step, ids)
            kw = dict(bits=bits, d=d, packed=tiered.packed)
            ops.reset_kernel_calls()
            got = ops.dequant_gather_staged(*args, **kw)
            want = ops.dequant_gather_staged(*args, **kw, use_kernel=False)
        else:
            ops.reset_kernel_calls()
            got = ops.dequant_gather(tiered, step, ids)
            want = ops.dequant_gather(tiered, step, ids, use_kernel=False)
        torch.cuda.synchronize()
        assert ops.kernel_calls() == {kernel: 1}
        assert bool((tiered.slots_for(ids) >= 0).any()) and torch.equal(got, want)
        if consistent:
            logical = CodeStore.from_codes(tiered.unpack(), bits)
            assert torch.equal(got, ops.dequant_gather(logical, step, ids))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [16, 15, 13])
@pytest.mark.parametrize("scratch", [True, False])
def test_routed_runs_form_bitwise(cuda, bits, d, scratch):
    """The runs form routed through a hot tier holding half of the wave's
    rows: both tiers, mu, nu and w_new bitwise against the plain routed
    version, and the logical table after the step equal to the untiered
    kernel's on the same operands."""
    from repro_torch.storage.tiered import HotRowCache

    g = _gen(700 + bits * d + scratch, cuda)
    n_live = 3000
    codes, step, mu, nu, uniq, _, g_occ, order, starts, noise = _runs_operands(
        g, cuda, n_live, d, bits, 4096, scratch)
    c1, c2 = lpt.adam_bias_corrections(5)
    live_ids = uniq[uniq < n_live]
    out = []
    for use_kernel in (True, False):
        cache = HotRowCache(1024, codes.shape[0])
        tiered = cache.observe_apply(cache.wrap(CodeStore.from_codes(codes.clone(), bits)),
                                     live_ids[::2].cpu().numpy())
        m, v = mu.clone(), nu.clone()
        ops.reset_kernel_calls()
        w_new = ops.sparse_row_update_runs(tiered, step, m, v, uniq, g_occ, order, starts, noise,
                                           0.01, c1, c2, bits, weight_decay=5e-8,
                                           use_kernel=use_kernel)
        torch.cuda.synchronize()
        out.append((tiered, m, v, w_new, ops.kernel_calls()))
    (kt, km, kv, kw, launched), (pt, pm, pv, pw, plain) = out
    kernel = "sparse_row_update_runs" + ("_packed" if bits < 8 else "") + "_routed"
    assert launched == {kernel: 1} and plain == {}
    live, real = slice(0, n_live), uniq < n_live
    assert int((kt.slots_for(live_ids) >= 0).sum()) == -(-live_ids.numel() // 2)
    assert torch.equal(kt.backing.data[live], pt.backing.data[live])
    assert torch.equal(kt.hot.data, pt.hot.data)
    assert torch.equal(km[live], pm[live]) and torch.equal(kv[live], pv[live])
    assert torch.equal(kw[real], pw[real])
    (uc, um, uv, uw, _), _ = _runs_both(codes, step, mu, nu, uniq, g_occ, order, starts, noise,
                                       bits, 5e-8, c1, c2)
    assert torch.equal(CodeStore.from_codes(kt.unpack(), bits).data[live], uc[live])
    assert torch.equal(km[live], um[live]) and torch.equal(kw[real], uw[real])


@pytest.mark.parametrize("bits", [8, 4])
def test_cold_tier_stages_only_the_misses_on_the_card(cuda, bits):
    """The cold tier on the card (pinned host rows, the side stream, the
    staging events): only the distinct uncached rows staged, admissions
    copied from them, a row evicted by its own wave topped up, a wave of
    hits with nothing staged; every read bitwise the warm gather's."""
    from repro_torch.storage.cold import ColdStore

    g = _gen(40 + bits, cuda)
    n, d = 40, 13
    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=cuda, dtype=torch.int8)
    step = torch.rand(n, generator=g, device=cuda) * 0.05 + 1e-3
    warm = CodeStore.from_codes(codes, bits)
    cold = ColdStore(warm, step, cache_rows=2)
    freqs = np.zeros(n, np.int64)
    freqs[[3, 5]] = 1
    cold.warm_start(freqs)
    kernel = "dequant_gather_packed_routed" if bits < 8 else "dequant_gather_routed"
    waves = [np.array([3, 7, 7, 7, 9, 9, 9, 9, 9, 11]), np.array([7, 9, 9, 7, 7, 9, 9, 7, 9, 7]),
             np.array([20, 21, 21, 7, 9, 30, 31, 32, 33, 34])]
    cold.stage(waves[0])
    for i, wave in enumerate(waves):
        cold.admit(wave)
        ops.reset_kernel_calls()
        got = cold.rows(wave)
        if i + 1 < len(waves):
            cold.stage(waves[i + 1])
        want = ops.dequant_gather(warm, step, torch.from_numpy(wave.astype(np.int32)).to(cuda),
                                  use_kernel=False)
        torch.cuda.synchronize()
        assert ops.kernel_calls() == {kernel: 1} and torch.equal(got, want), i
    assert cold.topup_rows == 1 and cold.prefetch_hits == 3 and cold.demand_puts == 0
    # warm 2, wave 0 staged 3 (+1 topped up), wave 1 none, wave 2 its 7 new ids
    assert cold.copied_rows == 2 + 3 + 1 + 0 + 7


def test_cuda_tiered_table_without_a_kernel_raises(cuda):
    """A table behind a hot-row cache on the card has no plain path: the
    kernels without a routed form refuse it, and a row step the runs form
    cannot take (DR rounding) raises instead of falling back."""
    g = _gen(9, cuda)
    tiered = _tiered_table(g, cuda, 64, 16, 8, 8, torch.arange(4, device=cuda))
    step = torch.full((64,), 0.01, device=cuda)
    with pytest.raises(TypeError, match="TieredCodes"):
        ops.lpt_update(tiered, step, torch.zeros(64, 16, device=cuda),
                       torch.rand(64, 16, device=cuda), 0.01, 8)
    with pytest.raises(TypeError, match="TieredCodes"):
        ops.dequant_matmul(torch.zeros(2, 16, device=cuda), tiered, step)
    table = lpt.LPTTable(codes=tiered, step=step, mu=torch.zeros(64, 16, device=cuda),
                         nu=torch.zeros(64, 16, device=cuda), count=0)
    ids = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="no plain path on the card"):
        lpt.sparse_apply(table, ids, torch.ones(8, 16, device=cuda), lr=0.01, bits=8,
                         rounding="dr", use_kernels=True)


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("alpt", 4), ("qr_alpt", 4),
                                         ("mixed", 8)])
def test_cache_on_training_and_serving_equal_cache_off_on_the_card(cuda, method, bits):
    """Cache-on training (a hot tier of 64 rows: evictions and dirty
    write-backs every step) through the routed kernels only, bitwise the
    cache-off run; its export served warm, through a hot tier and (lpt /
    alpt) through the cold tier, bitwise the uncached engine."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.training.ctr_trainer import checkpoint_tree

    synth, cfg = _small_ctr(method)
    cfg = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec, bits=bits))
    runs = []
    for cache_rows in (0, 64):
        c = dataclasses.replace(cfg, cache_rows=cache_rows)
        trainer = CTRTrainer(c, device=cuda)
        ops.reset_kernel_calls()
        state, hist = trainer.fit(synth, steps=5, batch_size=128)
        torch.cuda.synchronize()
        runs.append((trainer, trainer.export_state(state), hist, ops.kernel_calls()))
    (_, off, h_off, k_off), (tr_on, on, h_on, k_on) = runs
    assert [h["loss"] for h in h_on] == [h["loss"] for h in h_off]
    for (p, a), (q, b) in zip(ckpt.flatten(checkpoint_tree(cfg, on)),
                              ckpt.flatten(checkpoint_tree(cfg, off)), strict=True):
        assert p == q and (torch.equal(a.cpu(), b.cpu()) if isinstance(a, torch.Tensor)
                           else a == b), p
    assert not any(k.endswith("_routed") for k in k_off)
    assert not any(k.startswith(("dequant_gather", "sparse_row_update")) and
                   not k.endswith("_routed") for k in k_on)
    stats = tr_on.cache_stats()
    assert sum(s["evictions"] for s in stats) > 0 and sum(s["hits"] for s in stats) > 0
    ids, _ = synth.batch("test", 0, 300)
    scores = []
    for kw in ({}, {"cache_rows": 64}) + (({"cold_tier": True, "cache_rows": 64},)
                                         if method == "alpt" else ()):
        engine = CTREngine.from_state(off, cfg, batch=128, **kw)
        rids = [engine.submit(CTRRequest(ids=r)) for r in ids]
        done = engine.run()
        scores.append([done[r]["prob"] for r in rids])
        launched = engine.metrics().kernel_launches
        assert all(k.endswith("_routed") for k in launched) == bool(kw), launched
    assert all(s == scores[0] for s in scores[1:])


# ------------------------------------------------------------ data parallel


@pytest.mark.parametrize("bits", [8, 4, 3, 2])
@pytest.mark.parametrize("shape", [(4096, 16), (33,), ()])
def test_compressed_sync_twins_kernel_vs_plain_on_the_card(cuda, shape, bits):
    """Every rank's codes through sr_round (the scalar step expanded to the
    leaf's rows), bitwise the plain quantizer, at a table, a bias and a
    scalar leaf."""
    from repro_torch.dist import collectives

    g = _gen(bits + len(shape), cuda)
    stack = torch.randn((3, *shape), generator=g, device=cuda) * 0.01
    noise = [quant.sr_noise(g, shape) for _ in range(3)]
    ops.reset_kernel_calls()
    got = collectives.compressed_pmean_stacked(stack, noise, bits, use_kernels=True)
    torch.cuda.synchronize()
    assert ops.kernel_calls() == {"sr_round": 3}
    assert torch.equal(got, collectives.compressed_pmean_stacked(stack, noise, bits))
    assert torch.equal(collectives.exact_pmean_stacked(stack),
                       collectives.exact_pmean_stacked(stack.cpu()).to(cuda))


@pytest.mark.parametrize("method,sync", [
    ("alpt", 8), ("alpt", 32), ("alpt", 2), ("lpt", 4), ("qr_alpt", 8), ("qr_lpt", 8),
    ("mixed", 8), ("fp", 8), ("lsq", 4), ("pact", 8), ("hash", 8), ("prune", 8)])
def test_dp_microbatched_ctr_step_kernels_vs_plain(cuda, method, sync):
    """The twin (2 shards, 2 steps, dropout 0.2) kernels on and off from one
    seed: losses and every leaf bitwise; every sync leaf through sr_round,
    the dense lookups through the gathers, nothing falling back."""
    from repro_torch.training import ctr_trainer
    from repro_torch.training import data_parallel as dpm

    synth, cfg = _small_ctr(method, dropout=0.2)
    runs = []
    for use_kernels in (True, False):
        c = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec, use_kernels=use_kernels))
        trainer = CTRTrainer(c, device=cuda)
        step = dpm.make_ctr_microbatch_step(trainer, 2, dpm.DPConfig(sync_bits=sync,
                                                                      use_kernels=use_kernels))
        ops.reset_kernel_calls()
        ops.reset_fallbacks()
        state = trainer.init_state()
        losses = []
        for i in range(2):
            state, m = step(state, *synth.batch("train", i, 128))
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        assert ops.fallbacks() == []
        runs.append((ctr_trainer.checkpoint_tree(c, state), losses, ops.kernel_calls(),
                     len(dpm.ctr_grad_shapes(trainer, state))))
    (a, la, launched, leaves), (b, lb, plain, _) = runs
    assert la == lb and all(np.isfinite(la)) and plain == {}
    from repro_torch.checkpoint import manager as ckpt

    for (pa, x), (pb, y) in zip(ckpt.flatten(a), ckpt.flatten(b), strict=True):
        assert pa == pb and torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()), pa
    m = cfg.spec
    sync_sr = 2 * leaves * 2 * (sync < 32)
    learned = {"alpt": 1, "qr_alpt": 2}.get(method, 0)  # Delta leaves
    delta_sr = 2 * learned * 2 * (sync < 32) + 2 * learned  # synced, then line 5
    init_sr = {"alpt": 1, "lpt": 1, "qr_alpt": 2, "qr_lpt": 2, "mixed": 3}.get(method, 0)
    assert launched.get("sr_round", 0) == init_sr + sync_sr + delta_sr, launched
    if m.is_integer_table:
        assert launched.get("dequant_gather", 0) + launched.get("dequant_gather_packed", 0) >= 4


def test_dp_steps_through_a_one_rank_nccl_group_equal_their_twins(cuda):
    """``make_ctr_dp_step`` and ``make_lm_dp_step`` over a one-rank NCCL group
    bitwise their ``n_shards = 1`` twins (3 steps, sync 8)."""
    import torch.distributed as dist

    from repro_torch.training import ctr_trainer
    from repro_torch.training import data_parallel as dpm

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        synth, cfg = _small_ctr("alpt")
        trainer = CTRTrainer(dataclasses.replace(cfg, dp_sync_bits=8), device=cuda)
        trees = []
        for step in (dpm.make_ctr_dp_step(trainer), dpm.make_ctr_microbatch_step(trainer, 1)):
            state, losses = trainer.init_state(), []
            for i in range(3):
                state, m = step(state, *synth.batch("train", i, 128))
                losses.append(float(m["loss"]))
            trees.append((ctr_trainer.checkpoint_tree(trainer.cfg, state), losses))
        from repro_torch.checkpoint import manager as ckpt

        (a, la), (b, lb) = trees
        assert la == lb
        for (_, x), (_, y) in zip(ckpt.flatten(a), ckpt.flatten(b), strict=True):
            assert torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu())
        lm_cfg = dataclasses.replace(configs.smoke_config("smollm-135m"), embedding_method="alpt")
        tcfg = lm_trainer.LMTrainerConfig(dp_sync_bits=8)
        out = []
        for step in (dpm.make_lm_dp_step(lm_cfg, tcfg), dpm.make_lm_microbatch_step(lm_cfg,
                                                                                      tcfg, 1)):
            state, losses = lm_trainer.init_state(lm_cfg, tcfg, device=cuda), []
            for i in range(3):
                full = torch.from_numpy(LMTokenStream(lm_cfg.vocab_size, 33, seed=17).batch(
                    i, 4)).to(cuda)
                state, m = step(state, {"tokens": full[:, :-1], "labels": full[:, 1:]})
                losses.append(float(m["loss"]))
            out.append((losses, [t.clone() for t in tree_leaves(state.params)],
                        state.table.codes.data.clone(), state.table.step.clone()))
        (la, pa, ca, sa), (lb, pb, cb, sb) = out
        assert la == lb and torch.equal(ca, cb) and torch.equal(sa, sb)
        assert all(torch.equal(x, y) for x, y in zip(pa, pb, strict=True))
    finally:
        dist.destroy_process_group()


def test_fence_waits_for_the_card_only_while_tracing(cuda):
    """Disabled, the fence passes its value through and the host runs ahead
    of a ~10 ms kernel; enabled, a span fenced on a CUDA tensor lasts at
    least that kernel's event-timed duration."""
    from repro_torch.obs.trace import Tracer

    x = torch.zeros(1, device=cuda)
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    t = Tracer()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    assert t.fence({"loss": x}) is not None
    host_us = (time.perf_counter() - t0) * 1e6
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    assert host_us < start.elapsed_time(end) * 1e3 / 2
    t.enable()
    with t.span("train.step", step=0):
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        m = {"loss": x, "lr": 1e-3}
        assert t.fence(m) is m
    torch.cuda.synchronize()
    (ev,) = t.events
    kernel_us = start.elapsed_time(end) * 1e3
    assert kernel_us > 1000 and ev["dur"] >= kernel_us * 0.999


def test_traced_equals_untraced_on_the_card(cuda):
    """3 CTR steps (ALPT-8, kernels on) and one engine wave, traced and
    untraced from copies of one state: losses, every state tensor, the
    generator and the probabilities bitwise equal; the trace holds the
    spans."""
    from repro_torch.obs.trace import tracer

    data = CTRDatasetConfig(name="t", n_fields=6, cardinalities=(40, 9, 300, 17, 5, 1000))
    spec = EmbeddingSpec(method="alpt", n=data.n_features, d=16, bits=8, pad_to_tiles=True)
    cfg = TrainerConfig(spec=spec, dcn=DCNConfig(n_fields=6, emb_dim=16, cross_depth=2,
                                                 mlp_widths=(64, 32)))
    synth = CTRSynthetic(data)
    batches = [synth.batch("train", i, 128) for i in range(3)]
    test_ids = synth.batch("test", 0, 64)[0]
    state0 = init_state(cfg, device=cuda)
    runs = []
    for traced in (False, True):
        if traced:
            tracer().enable()
        try:
            trainer = CTRTrainer(cfg, device=cuda)
            state, losses = clone_state(state0), []
            for ids, labels in batches:
                state, m = trainer.train_step(state, ids, labels)
                losses.append(float(m["loss"]))
            engine = CTREngine.from_state(state, cfg, batch=64)
            rids = [engine.submit(CTRRequest(ids=row)) for row in test_ids]
            done = engine.run()
            events = tracer().events
        finally:
            tracer().disable()
            tracer().clear()
        t = state.emb_state
        runs.append((losses, [t.codes.data, t.step, t.mu, t.nu, *state.dense.parameters()],
                     state.generator.get_state(), [done[r]["prob"] for r in rids], events))
    (la, ta, ga, pa, ea), (lb, tb, gb, pb, eb) = runs
    assert la == lb and pa == pb and torch.equal(ga, gb) and ea == []
    assert all(torch.equal(x, y) for x, y in zip(ta, tb, strict=True))
    names = collections.Counter(e["name"] for e in eb)
    assert (names["train.step"], names["train.writeback"], names["engine.wave"],
            names["engine.score"]) == (3, 3, 1, 1)


# ------------------------------------------------------------------ faults


def _fault_plan(*specs):
    from repro_torch import faults

    return faults.FaultPlan(specs=tuple(faults.FaultSpec(site=s, steps=st, always=a,
                                                         params=p or {})
                                        for s, st, a, p in specs))


def _state_tensors(state):
    t = state.emb_state
    return [t.codes.data, t.step, t.mu, t.nu, *state.dense.parameters(),
            *state.dense_opt.mu, *state.dense_opt.nu, state.generator.get_state()]


def test_guard_rollback_on_the_card_is_bitwise(cuda):
    """ALPT-8 with the kernels on, 4 steps: guarded without a plan ==
    unguarded bitwise; ``trainer.nonfinite`` at step 1 and ``alpt.delta`` at
    step 2: each fired step leaves every tensor of the state as before it
    (the generator advanced as unguarded), one skip each, the kernels
    launched on every step."""
    from repro_torch import faults

    synth, cfg = _small_ctr("alpt")
    state0 = init_state(cfg, device=cuda)
    batches = [synth.batch("train", i, 128) for i in range(4)]

    def run(guard, plan=None):
        faults.install(plan)
        try:
            trainer = CTRTrainer(dataclasses.replace(cfg, guard=guard), device=cuda)
            state, out = clone_state(state0), []
            ops.reset_kernel_calls()
            for ids, labels in batches:
                before = [x.clone() for x in _state_tensors(state)]
                state, m = trainer.train_step(state, ids, labels)
                out.append((before, [x.clone() for x in _state_tensors(state)], float(m["loss"])))
            torch.cuda.synchronize()
            return out, trainer.guard_stats, ops.kernel_calls()
        finally:
            faults.uninstall()

    plain, _, launched = run(False)
    guarded, stats, launched_g = run(True)
    assert stats.skipped == 0 and launched_g == launched
    for (_, a, la), (_, b, lb) in zip(plain, guarded):
        assert la == lb and all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    chaos, stats, launched_c = run(True, _fault_plan(("trainer.nonfinite", (1,), False, None),
                                                     ("alpt.delta", (2,), False, None)))
    assert (stats.skipped, stats.nonfinite_fired, stats.delta_fired) == (2, 1, 1)
    assert launched_c["sparse_row_update_runs"] == 4 and launched_c["adam_update"] == 4
    for i in (1, 2):
        before, after, _ = chaos[i]
        *tensors, gen = after
        assert all(torch.equal(x, y) for x, y in zip(before[:-1], tensors, strict=True)), i
        assert torch.equal(gen, plain[i][1][-1])
    assert all(torch.equal(x, y) for x, y in zip(chaos[0][1], plain[0][1], strict=True))


def test_forced_fallback_on_the_card_is_counted_and_bitwise(cuda):
    """``kernels.force_fallback`` over 2 ALPT-8 steps on the card: the state
    and losses of the kernels-on run, each forced dispatch counted with
    reason ``fault-injected`` and launching nothing; after ``uninstall()``
    the same steps fall back nowhere and launch again."""
    from repro_torch import faults

    synth, cfg = _small_ctr("alpt")
    state0 = init_state(cfg, device=cuda)
    batches = [synth.batch("train", i, 128) for i in range(2)]

    def run():
        trainer = CTRTrainer(cfg, device=cuda)
        state, losses = clone_state(state0), []
        ops.reset_kernel_calls()
        with ops.fallback_scope() as scope:
            for ids, labels in batches:
                state, m = trainer.train_step(state, ids, labels)
                losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        return state, losses, ops.kernel_calls(), scope.stats()

    on, l_on, launched, st = run()
    assert st["total_fallbacks"] == 0
    faults.install(_fault_plan(("kernels.force_fallback", (), True, None)))
    try:
        forced, l_forced, launched_f, st_f = run()
    finally:
        faults.uninstall()
    assert l_on == l_forced
    # The scratch row takes the dedup sentinel's run: unspecified between a
    # kernel and its plain version, so the table is compared over its live rows.
    assert all(torch.equal(x, y) for x, y in zip(_live(on.emb_state, cfg.spec),
                                                 _live(forced.emb_state, cfg.spec), strict=True))
    assert all(torch.equal(x, y) for x, y in zip(_state_tensors(on)[4:], _state_tensors(forced)[4:],
                                                 strict=True))
    assert launched_f == {} and {f["reason"] for f in st_f["fallbacks"]} == {"fault-injected"}
    assert st_f["total_fallbacks"] == sum(launched.values())
    again, _, launched_a, st_a = run()
    assert st_a["total_fallbacks"] == 0 and launched_a == launched


def test_no_fallback_on_the_card_without_a_plan(cuda):
    """With no plan (and after a plan is gone) a CUDA dispatch launches its
    kernel: no fallback is noted."""
    from repro_torch import faults

    g = _gen(7, cuda)
    codes = torch.randint(-127, 128, (64, 16), generator=g, device=cuda, dtype=torch.int8)
    step = torch.rand(64, generator=g, device=cuda) * 0.05
    ids = torch.randint(0, 64, (100,), generator=g, device=cuda, dtype=torch.int32)
    faults.install(_fault_plan(("kernels.force_fallback", (), True, {"ops": ["sr_round"]})))
    faults.uninstall()
    ops.reset_kernel_calls()
    with ops.fallback_scope() as scope:
        ops.dequant_gather(codes, step, ids)
        ops.sr_round(torch.randn(64, 16, generator=g, device=cuda), step,
                     torch.rand(64, 16, generator=g, device=cuda))
    torch.cuda.synchronize()
    assert scope.stats()["total_fallbacks"] == 0
    assert ops.kernel_calls() == {"dequant_gather": 1, "sr_round": 1}


@pytest.mark.parametrize("bits", [8, 4])
def test_cold_tier_seams_on_the_card_are_bitwise(cuda, bits):
    """The cold tier on the card (pinned rows, the side stream) with
    ``codestore.corrupt``, ``cold.fetch`` (2 failures) and
    ``cold.prefetch_loss`` on three staged waves: every read bitwise the
    fault-free store's, each seam counted once."""
    from repro_torch import faults
    from repro_torch.storage.cold import ColdStore

    g = _gen(60 + bits, cuda)
    n, d = 400, 16
    lo, hi = quant.code_bounds(bits)
    codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=cuda, dtype=torch.int8)
    step = torch.rand(n, generator=g, device=cuda) * 0.05 + 1e-3
    warm = CodeStore.from_codes(codes, bits)
    rs = np.random.RandomState(bits)
    waves = [rs.randint(0, n, size=96) for _ in range(4)]

    def serve():
        cold = ColdStore(warm, step, cache_rows=16)
        out = []
        for i, wave in enumerate(waves):
            cold.admit(wave)
            out.append(cold.rows(wave))
            if i + 1 < len(waves):
                cold.stage(waves[i + 1])
        torch.cuda.synchronize()
        return out, cold

    want, _ = serve()
    faults.install(_fault_plan(("codestore.corrupt", (1,), False, None),
                               ("cold.fetch", (2,), False, {"fails": 2}),
                               ("cold.prefetch_loss", (3,), False, None)))
    try:
        got, cold = serve()
    finally:
        faults.uninstall()
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    assert (cold.corruption_detected, cold.prefetch_dropped, cold.retry_stats.retries,
            cold.retry_stats.failures) == (1, 1, 2, 0)


# --------------------------------------------------------------- the sharding path


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("blocks", [2, 4])
def test_write_back_kernels_on_row_shards_equal_the_whole_call(cuda, bits, blocks):
    """sr_round and lpt_fused_update(_packed) on each rank's row block of a
    table equal the one-process call's rows bitwise (the sharded step's
    write-back, rung 1), the operands the whole call's rows."""
    g = _gen(300 + bits + blocks, cuda)
    n, d = 4096, 64
    w = torch.randn(n, d, generator=g, device=cuda) * 0.02
    step = quant.init_step_size(w, 8)
    noise = quant.sr_noise(g, (n, d))
    upd = torch.randn(n, d, generator=g, device=cuda)
    full = ops.sr_round(w, step, noise, 8)
    codes = CodeStore.from_codes(torch.clamp(full, *quant.code_bounds(bits)), bits)
    whole = ops.lpt_update(codes, step, upd, noise, 3e-4, bits, weight_decay=5e-8)
    k = n // blocks
    for r in range(blocks):
        rows = slice(r * k, (r + 1) * k)
        got = ops.sr_round(w[rows].contiguous(), step[rows].contiguous(), noise[rows].contiguous(),
                           8)
        assert torch.equal(got, full[rows])
        shard = CodeStore(data=codes.data[rows].contiguous(), bits=bits, n=k, d=d,
                          packed=codes.packed)
        new = ops.lpt_update(shard, step[rows].contiguous(), upd[rows].contiguous(),
                             noise[rows].contiguous(), 3e-4, bits, weight_decay=5e-8)
        assert torch.equal(new.data, whole.data[rows])


def test_gloo_1x2_step_on_the_card_tracks_the_one_process_step(cuda, tmp_path):
    """Two gloo ranks on the one card (a 1 x 2 grid, tp), each its shard of
    the one-process init of qwen3-1.7b's smoke config, one ALPT-8 step:
    loss within 1e-4 of the one-process step on the card, codes differing
    on at most 0.5%, every replicated leaf the same on both ranks."""
    import pathlib
    import subprocess
    import sys

    cfg = configs.smoke_config("qwen3-1.7b")
    tcfg = lm_trainer.LMTrainerConfig()
    full = torch.from_numpy(LMTokenStream(cfg.vocab_size, 64, seed=17).batch(0, 2))
    batch = {"tokens": full[:, :-1].contiguous(), "labels": full[:, 1:].contiguous()}
    torch.save({"steps": {"qwen3": {"cfg": cfg, "tcfg": tcfg, "policy": "tp", "seed": 9,
                                    "batch": batch}}}, tmp_path / "in.pt")
    root = pathlib.Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen([sys.executable, str(root / "tests" / "_torch_sharded_ranks.py"),
                               str(tmp_path), str(r), "2", "1", "2", "cuda"], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:] for e in errs]
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)
    assert got["same_replicas"]
    got = got["steps"]["qwen3"]
    state = lm_trainer.init_state(cfg, tcfg, seed=9, device=cuda)
    state, m = lm_trainer.make_train_step(cfg, tcfg)(state, {k: v.to(cuda)
                                                            for k, v in batch.items()})
    assert abs(got["metrics"]["loss"] - float(m["loss"])) < 1e-4
    frac = (got["table"]["codes"] != state.table.codes.data.cpu()).float().mean()
    assert float(frac) <= 0.005
