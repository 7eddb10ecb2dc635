"""Port parity: table init and lookup (repro_torch.core.lpt vs repro.core.lpt).

JAX's threefry draws cannot be reproduced in torch, so the test repeats the
reference's key split (``core/lpt.py:85-95``) to get its own ``w`` and SR
noise, hands them to the port's ``table_from_init``, and requires the code
container's bytes and the steps to equal the reference's ``init_table``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lpt as jlpt
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro_torch.core import lpt as plpt
from repro_torch.kernels import ops as pops


def _reference_draws(key, n, d, init_scale=1e-2):
    kw, kn = jax.random.split(key)
    w = jax.random.normal(kw, (n, d), jnp.float32) * init_scale
    return np.array(w), np.array(jq.sr_noise(kn, (n, d)))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n,d", [(64, 16), (37, 15)])
@pytest.mark.parametrize("knob", [{}, {"clip_value": 0.05}, {"step_size": 0.003}])
def test_init_table_bitwise_vs_reference(bits, n, d, knob):
    key = jax.random.PRNGKey(bits * 7 + n)
    with jops.fallback_scope() as scope:
        ref = jlpt.init_table(key, n, d, bits, use_kernels=True, **knob)
    # The reference's sr_round is the interpreted Pallas kernel when the shape
    # is a multiple of 8, and its jnp oracle otherwise.
    aligned = n % 8 == 0 and d % 8 == 0
    assert scope.stats()["kernel_calls"].get("sr_round", 0) == int(aligned)
    w, noise = _reference_draws(key, n, d)
    got = plpt.table_from_init(torch.from_numpy(w), torch.from_numpy(noise), bits,
                               use_kernels=True, **knob)
    assert (got.codes.packed, got.codes.bits, got.codes.shape) == (
        ref.codes.packed, ref.codes.bits, ref.codes.shape)
    np.testing.assert_array_equal(got.codes.data.numpy(), np.asarray(ref.codes.data))
    np.testing.assert_array_equal(got.step.numpy().view(np.int32),
                                  np.asarray(ref.step).view(np.int32))
    assert got.mu.shape == ref.mu.shape and got.nu.shape == ref.nu.shape
    assert not got.mu.any() and not got.nu.any()


@pytest.mark.parametrize("optimizer,slot", [("adam", (16, 8)), ("adagrad", (16,)), ("sgd", (16,))])
def test_init_table_optimizer_slots(optimizer, slot):
    t = plpt.init_table(torch.Generator().manual_seed(0), 16, 8, 8, optimizer=optimizer)
    assert t.mu.shape == t.nu.shape == slot
    with pytest.raises(ValueError):
        plpt.init_table(torch.Generator(), 4, 8, 8, optimizer="lion")


def test_init_table_seeded_and_in_range():
    a = plpt.init_table(torch.Generator().manual_seed(3), 100, 16, 4)
    b = plpt.init_table(torch.Generator().manual_seed(3), 100, 16, 4)
    assert a.codes.packed and a.codes.data.shape == (100, 8)
    assert torch.equal(a.codes.data, b.codes.data) and torch.equal(a.step, b.step)
    codes = a.codes.unpack()
    assert int(codes.min()) >= -8 and int(codes.max()) <= 7
    assert (a.n_rows, a.dim) == (100, 16)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_lookup_bitwise_vs_reference(bits, use_kernels):
    key = jax.random.PRNGKey(bits)
    ref = jlpt.init_table(key, 48, 16, bits)
    w, noise = _reference_draws(key, 48, 16)
    table = plpt.table_from_init(torch.from_numpy(w), torch.from_numpy(noise), bits)
    ids = np.array([[0, 47, 3], [3, 3, 9]], np.int32)
    expect = np.asarray(jlpt.lookup(ref, jnp.asarray(ids), use_kernels=True))
    pops.reset_kernel_calls()
    got = plpt.lookup(table, torch.from_numpy(ids), use_kernels=use_kernels)
    assert pops.kernel_calls() == {}
    assert got.shape == (2, 3, 16)
    np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(
        plpt.lookup(table, torch.from_numpy(ids), use_kernels=use_kernels, out_dim=10).numpy(),
        expect[..., :10],
    )
