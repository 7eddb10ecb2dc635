"""Port parity: repro_torch.core.codestore against repro.core.codestore, bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codestore as jcs
from repro_torch.core import codestore as pcs


def _codes(rng, bits, shape):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return rng.randint(lo, hi + 1, size=shape).astype(np.int8)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("d", [16, 15, 7, 1])
def test_pack_unpack_match_reference_bitwise(bits, d):
    codes = _codes(np.random.RandomState(10 * bits + d), bits, (9, d))
    ref_packed = np.asarray(jcs.pack_codes(jnp.asarray(codes), bits))
    packed = pcs.pack_codes(torch.from_numpy(codes), bits)
    assert packed.dtype == torch.uint8
    assert packed.shape == (9, pcs.packed_width(d, bits))
    np.testing.assert_array_equal(packed.numpy(), ref_packed)
    unpacked = pcs.unpack_codes(packed, bits, d)
    assert unpacked.dtype == torch.int8
    np.testing.assert_array_equal(
        unpacked.numpy(), np.asarray(jcs.unpack_codes(jnp.asarray(ref_packed), bits, d))
    )
    np.testing.assert_array_equal(unpacked.numpy(), codes)


@pytest.mark.parametrize("bits", [2, 4])
def test_unpack_of_arbitrary_bytes_matches_reference(bits):
    # Every byte value, pad bits included: sign extension and the slice back
    # to the logical width agree with the reference for any container byte.
    data = np.arange(256, dtype=np.uint8).reshape(32, 8)
    d = 8 * (8 // bits) - 1
    np.testing.assert_array_equal(
        pcs.unpack_codes(torch.from_numpy(data), bits, d).numpy(),
        np.asarray(jcs.unpack_codes(jnp.asarray(data), bits, d)),
    )


def test_layout_helpers_match_reference():
    for bits in (2, 4):
        assert pcs.codes_per_byte(bits) == jcs.codes_per_byte(bits)
        for d in (1, 15, 16, 17):
            assert pcs.packed_width(d, bits) == jcs.packed_width(d, bits)
    for bits in (3, 8):
        assert not pcs.is_packable(bits)
        with pytest.raises(ValueError):
            pcs.codes_per_byte(bits)


@pytest.mark.parametrize("bits,packed", [(8, None), (4, None), (2, None), (4, False), (8, True)])
@pytest.mark.parametrize("d", [16, 15])
def test_codestore_layout_and_take_match_reference(bits, packed, d):
    codes = _codes(np.random.RandomState(bits + d), bits, (24, d))
    ref = jcs.CodeStore.from_codes(jnp.asarray(codes), bits, packed=packed)
    port = pcs.CodeStore.from_codes(torch.from_numpy(codes), bits, packed=packed)
    assert (port.packed, port.bits, port.n, port.d) == (ref.packed, ref.bits, ref.n, ref.d)
    assert port.shape == ref.shape == (24, d)
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    assert port.resident_bytes == ref.resident_bytes
    ids = np.array([3, 3, 0, 23, 7], np.int32)
    np.testing.assert_array_equal(port.take(torch.from_numpy(ids)).numpy(),
                                  np.asarray(ref.take(jnp.asarray(ids))))
    np.testing.assert_array_equal(port.unpack().numpy(), codes)
