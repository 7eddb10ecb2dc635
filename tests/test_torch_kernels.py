"""Port parity: the plain versions behind repro_torch.kernels.ops against the
reference's kernels, bitwise.

The reference runs with ``use_kernel=True``.  Where its shape gate admits
the call (rows and width multiples of 8), the oracle is the Pallas kernel
itself, run in interpret mode on the CPU, and the test asserts through
``fallback_scope`` that it ran.  At d=15 (and ragged row counts) the
reference gates the call to its jnp oracle (``kernels/ops.py:461-464`` and
``:479-482``); that oracle is the kernel's documented bitwise twin, so it is
still a valid oracle, and the test asserts the fallback happened instead.

The CUDA kernels themselves run only on a GPU: tests/test_torch_cuda.py
holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codestore as jcs
from repro.kernels import ops as jops
from repro_torch.core import codestore as pcs
from repro_torch.kernels import _build
from repro_torch.kernels import dequant_gather as gather_kernel
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import sr_round as sr_kernel


def _assert_oracle(scope, op, kernel_eligible):
    stats = scope.stats()
    if kernel_eligible:
        assert stats["kernel_calls"].get(op) == 1, stats
        assert stats["total_fallbacks"] == 0, stats
    else:
        assert stats["kernel_calls"].get(op, 0) == 0, stats
        assert stats["total_fallbacks"] == 1, stats


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    pops.reset_kernel_calls()
    yield
    # Every call here had CPU tensors: none may have launched a kernel.
    assert pops.kernel_calls() == {}


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("rows,cols", [(64, 16), (40, 16), (37, 15), (9, 13)])
def test_sr_round_plain_matches_reference_kernel(rows, cols, bits):
    rng = np.random.RandomState(rows * cols + bits)
    w = (rng.standard_normal((rows, cols)) * 0.05).astype(np.float32)
    step = rng.uniform(1e-3, 2e-2, rows).astype(np.float32)
    noise = rng.uniform(0.0, 1.0, (rows, cols)).astype(np.float32)
    with jops.fallback_scope() as scope:
        ref = np.asarray(jops.sr_round(jnp.asarray(w), jnp.asarray(step),
                                       jnp.asarray(noise), bits, use_kernel=True))
    _assert_oracle(scope, "sr_round", rows % 8 == 0 and cols % 8 == 0)
    got = pops.sr_round(torch.from_numpy(w), torch.from_numpy(step),
                        torch.from_numpy(noise), bits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)


def _gather_operands(seed, n, d, b):
    rng = np.random.RandomState(seed)
    codes = rng.randint(-128, 128, (n, d)).astype(np.int8)
    step = rng.uniform(1e-3, 1e-1, n).astype(np.float32)
    # Repeated ids, the first and the last row included.
    ids = np.concatenate([rng.randint(0, n, b - 4), [0, n - 1, 5, 5]]).astype(np.int32)
    return codes, step, ids


@pytest.mark.parametrize("d", [16, 15])
def test_dequant_gather_plain_matches_reference_kernel(d):
    codes, step, ids = _gather_operands(d, 48, d, 32)
    with jops.fallback_scope() as scope:
        ref = np.asarray(jops.dequant_gather(jnp.asarray(codes), jnp.asarray(step),
                                             jnp.asarray(ids), use_kernel=True))
    _assert_oracle(scope, "dequant_gather", d % 8 == 0)
    got = pops.dequant_gather(torch.from_numpy(codes), torch.from_numpy(step),
                              torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (32, d)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("d", [16, 15])
def test_dequant_gather_packed_plain_matches_reference_kernel(bits, d):
    codes, step, ids = _gather_operands(bits * d, 48, d, 32)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = np.clip(codes, lo, hi).astype(np.int8)
    ref_store = jcs.CodeStore.from_codes(jnp.asarray(codes), bits)
    with jops.fallback_scope() as scope:
        ref = np.asarray(jops.dequant_gather(ref_store, jnp.asarray(step),
                                             jnp.asarray(ids), use_kernel=True))
    _assert_oracle(scope, "dequant_gather", d % 8 == 0)
    store = pcs.CodeStore.from_codes(torch.from_numpy(codes), bits)
    assert store.packed
    got = pops.dequant_gather(store, torch.from_numpy(step), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), ref)
    # The packed plain version equals the int8 one on the unpacked codes.
    np.testing.assert_array_equal(
        got.numpy(),
        pref.dequant_gather_ref(torch.from_numpy(codes), torch.from_numpy(step),
                                torch.from_numpy(ids)).numpy(),
    )


def test_use_kernel_false_takes_plain_version():
    codes, step, ids = _gather_operands(1, 16, 16, 8)
    a = pops.dequant_gather(torch.from_numpy(codes), torch.from_numpy(step),
                            torch.from_numpy(ids), use_kernel=False)
    b = pref.dequant_gather_ref(torch.from_numpy(codes), torch.from_numpy(step),
                                torch.from_numpy(ids))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    # A wrapper takes only CUDA tensors: it raises before building or
    # launching anything, and nothing is counted.
    w = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sr_kernel.sr_round(w, torch.ones(8), torch.zeros(8, 16), 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_kernel.dequant_gather(torch.zeros(8, 16, dtype=torch.int8), torch.ones(8),
                                     torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="bits must be 2 or 4"):
        gather_kernel.dequant_gather_packed(torch.zeros(8, 8, dtype=torch.uint8),
                                            torch.ones(8), torch.zeros(4, dtype=torch.int32),
                                            bits=8, d=16)
    with pytest.raises(ValueError, match="bits must be in"):
        sr_kernel.sr_round(w, torch.ones(8), torch.zeros(8, 16), 9)


def test_build_keys_and_missing_nvcc(monkeypatch, tmp_path):
    # Each source has its own library, keyed by the source and the flags.
    paths = {name: _build._library_path(name) for name in _build.SIGNATURES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR and path.name.startswith(name + "-")
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.pathlib.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
