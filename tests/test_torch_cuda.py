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

from repro_torch.core import quant
from repro_torch.core.codestore import CodeStore
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.kernels import dequant_gather as gather_kernel
from repro_torch.kernels import ops, ref
from repro_torch.methods import EmbeddingSpec
from repro_torch.models.ctr import DCNConfig
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.training.ctr_trainer import TrainerConfig, init_state

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
