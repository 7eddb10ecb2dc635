"""Port parity: repro_torch.core.quant against repro.core.quant.

Quantize and dequantize are bitwise equal on shared operands (the SR noise
is drawn once with numpy and handed to both).  ``init_step_size`` is bitwise
at the narrow rows the paper uses, where both sum each row left to right;
on wide rows XLA sums in vector lanes, so there it is held at rtol=1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as pq


def _operands(rng, rows, cols):
    # Wide enough to clip at every bit width, with per-row steps.
    w = (rng.standard_normal((rows, cols)) * 0.05).astype(np.float32)
    step = rng.uniform(1e-3, 2e-2, rows).astype(np.float32)
    noise = rng.uniform(0.0, 1.0, (rows, cols)).astype(np.float32)
    return w, step, noise


def test_code_bounds_match_reference():
    for bits in range(2, 9):
        assert pq.code_bounds(bits) == jq.code_bounds(bits)
    for bits in (1, 9):
        with pytest.raises(ValueError):
            pq.code_bounds(bits)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("cols", [16, 15])
@pytest.mark.parametrize("rounding", ["sr", "dr"])
def test_quantize_codes_bitwise(bits, cols, rounding):
    w, step, noise = _operands(np.random.RandomState(bits * cols), 40, cols)
    ref = jq.quantize_codes(jnp.asarray(w), jnp.asarray(step), bits, rounding,
                            jnp.asarray(noise) if rounding == "sr" else None)
    got = pq.quantize_codes(torch.from_numpy(w), torch.from_numpy(step), bits, rounding,
                            torch.from_numpy(noise) if rounding == "sr" else None)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantize_codes_scalar_step_and_errors():
    w, _, noise = _operands(np.random.RandomState(3), 8, 16)
    ref = jq.quantize_codes(jnp.asarray(w), 0.01, 4, "sr", jnp.asarray(noise))
    got = pq.quantize_codes(torch.from_numpy(w), 0.01, 4, "sr", torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        pq.quantize_codes(torch.from_numpy(w), 0.01, 4, "sr", None)
    with pytest.raises(ValueError):
        pq.quantize_codes(torch.from_numpy(w), 0.01, 4, "nearest")


def test_dequantize_bitwise():
    rng = np.random.RandomState(4)
    codes = rng.randint(-128, 128, (12, 15)).astype(np.int8)
    step = rng.uniform(1e-3, 1e-1, 12).astype(np.float32)
    np.testing.assert_array_equal(
        pq.dequantize(torch.from_numpy(codes), torch.from_numpy(step)).numpy(),
        np.asarray(jq.dequantize(jnp.asarray(codes), jnp.asarray(step))),
    )


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("cols", [16, 15])
def test_init_step_size_bitwise_on_narrow_rows(bits, cols):
    w = (np.random.RandomState(bits + cols).standard_normal((64, cols)) * 0.01).astype(np.float32)
    ref = np.asarray(jq.init_step_size(jnp.asarray(w), bits))
    got = pq.init_step_size(torch.from_numpy(w), bits).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("per_row", [True, False])
def test_init_step_size_wide_rows_rtol(per_row):
    # rtol=1e-6: XLA reduces wide rows (and the whole table) in another
    # summation order than the port's left-to-right row sum / torch.mean.
    w = (np.random.RandomState(7).standard_normal((32, 64)) * 0.01).astype(np.float32)
    ref = np.asarray(jq.init_step_size(jnp.asarray(w), 8, per_row=per_row))
    got = pq.init_step_size(torch.from_numpy(w), 8, per_row=per_row).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_init_step_size_floor():
    got = pq.init_step_size(torch.zeros(3, 16), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.init_step_size(jnp.zeros((3, 16)), 8)))


def test_sr_noise_uniform_on_generator_device():
    g = torch.Generator().manual_seed(5)
    u = pq.sr_noise(g, (1000, 16))
    assert u.dtype == torch.float32 and u.device == g.device
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    np.testing.assert_array_equal(u.numpy(), pq.sr_noise(torch.Generator().manual_seed(5),
                                                         (1000, 16)).numpy())
