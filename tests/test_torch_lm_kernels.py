"""The LM slice's kernels, plain versions, against the JAX package.

``dequant_matmul`` / ``dequant_matmul_packed`` and ``flash_attention_fwd``
take their plain PyTorch versions here (CPU tensors); the reference runs its
Pallas kernels in interpret mode, as its own tests run them, and its jnp
oracles.  The CUDA kernels themselves are held against these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances:
* the head: every logit within the fp32 error bound of a K-term sum,
  ``gamma_{K+1} * (|x| @ |w|.T)`` with ``gamma_n = n u / (1 - n u)``,
  ``u = 2**-24``, of the float64 value (the products' and the sum's
  rounding, in any order), and the two packages within twice that of each
  other;
* attention: atol 3e-5, rtol 2e-4, as tests/test_flash_kernel.py holds the
  Pallas kernel (exp and sums in another order, online rescaling).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codestore import pack_codes as jpack
from repro.kernels import dequant_matmul as jmm
from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.core.codestore import CodeStore
from repro_torch.kernels import dequant_matmul as mm_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ops, ref

jax.config.update("jax_platform_name", "cpu")

U = 2.0 ** -24


def _head_operands(m, n, k, bits, seed):
    rng = np.random.RandomState(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    x = rng.randn(m, k).astype(np.float32)
    codes = rng.randint(lo, hi + 1, (n, k)).astype(np.int8)
    step = (rng.rand(n) * 0.01 + 1e-4).astype(np.float32)
    return x, codes, step


def _bound(x, codes, step):
    """gamma_{K+1} * (|x| @ |w|.T) and the float64 value."""
    k = x.shape[1]
    w = codes.astype(np.float64) * step.astype(np.float64)[:, None]
    gamma = (k + 1) * U / (1 - (k + 1) * U)
    return gamma * (np.abs(x.astype(np.float64)) @ np.abs(w).T), x.astype(np.float64) @ w.T


# (m, n, k, reference blocks (bm, bn, bk)): divisible tilings and whole-array
# blocks at ragged shapes, as the reference's ops run them off the TPU.
HEAD_CASES = [
    (8, 256, 64, (8, 128, 32)),
    (1, 512, 48, (1, 128, 48)),
    (3, 37, 13, (3, 37, 13)),
    (16, 96, 576, (8, 32, 576)),
]


@pytest.mark.parametrize("m,n,k,blocks", HEAD_CASES)
def test_dequant_matmul_plain_matches_reference_kernel(m, n, k, blocks):
    x, codes, step = _head_operands(m, n, k, 8, seed=m + n + k)
    bound, exact = _bound(x, codes, step)
    bm, bn, bk = blocks
    got = ops.dequant_matmul(torch.from_numpy(x), torch.from_numpy(codes),
                             torch.from_numpy(step)).numpy()
    pallas = np.asarray(jmm.dequant_matmul(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(step),
                                           block_m=bm, block_n=bn, block_k=bk, interpret=True))
    oracle = np.asarray(jax.jit(jref.dequant_matmul_ref)(x, codes, step))
    assert got.shape == (m, n) and got.dtype == np.float32
    for name, y in (("port", got), ("pallas", pallas), ("oracle", oracle)):
        excess = np.abs(y.astype(np.float64) - exact) - bound
        assert excess.max() <= 0, (name, float(excess.max()))
    assert (np.abs(got.astype(np.float64) - pallas) <= 2 * bound).all()
    assert (np.abs(got.astype(np.float64) - oracle) <= 2 * bound).all()


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("m,n,k", [(8, 256, 64), (3, 37, 13), (2, 40, 15), (4, 128, 576)])
def test_dequant_matmul_packed_plain_matches_reference_kernel(m, n, k, bits):
    x, codes, step = _head_operands(m, n, k, bits, seed=7 * k + bits)
    bound, exact = _bound(x, codes, step)
    store = CodeStore.from_codes(torch.from_numpy(codes), bits)
    packed = np.asarray(jpack(jnp.asarray(codes), bits))
    np.testing.assert_array_equal(store.data.numpy(), packed)  # the same container bytes
    got = ops.dequant_matmul(torch.from_numpy(x), store, torch.from_numpy(step)).numpy()
    pallas = np.asarray(jmm.dequant_matmul_packed(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(step), bits=bits, k=k,
        block_m=m, block_n=n, interpret=True))
    oracle = np.asarray(jax.jit(jref.dequant_matmul_packed_ref, static_argnames=("bits", "k"))(
        x, packed, step, bits=bits, k=k))
    for name, y in (("port", got), ("pallas", pallas), ("oracle", oracle)):
        excess = np.abs(y.astype(np.float64) - exact) - bound
        assert excess.max() <= 0, (name, float(excess.max()))
    assert (np.abs(got.astype(np.float64) - pallas) <= 2 * bound).all()


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("k", [576, 15, 1])
def test_dequant_matmul_packed_equals_int8_bitwise(bits, k):
    x, codes, step = _head_operands(5, 33, k, bits, seed=k + bits)
    xt, ct, st = torch.from_numpy(x), torch.from_numpy(codes), torch.from_numpy(step)
    store = CodeStore.from_codes(ct, bits)
    assert store.packed
    ops.reset_kernel_calls()
    packed = ops.dequant_matmul(xt, store, st)
    assert torch.equal(packed, ops.dequant_matmul(xt, ct, st))
    assert torch.equal(packed, ops.dequant_matmul(xt, CodeStore.from_codes(ct, 8), st))
    assert torch.equal(packed, ref.dequant_matmul_packed_ref(xt, store.data, st, bits=bits, k=k))
    assert ops.kernel_calls() == {}  # CPU tensors take the plain versions
    # The reference promises the same of its packed kernel at whole-K blocks.
    with jops.fallback_scope():
        jp = jops.dequant_matmul(jnp.asarray(x), _jstore(codes, bits), jnp.asarray(step))
        ji = jops.dequant_matmul(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(step))
    np.testing.assert_array_equal(np.asarray(jp), np.asarray(ji))


def _jstore(codes, bits):
    from repro.core.codestore import CodeStore as JStore

    return JStore.from_codes(jnp.asarray(codes), bits)


# (t, s, h, kh, d, causal, window): tests/test_flash_kernel.py's cases, then
# the LM slice's head dims (64 SmolLM, 80 Danube, 128 Qwen3) and GQA 3:1.
FLASH_CASES = [
    (64, 64, 2, 2, 32, True, None),
    (64, 64, 4, 2, 16, True, None),
    (96, 96, 2, 1, 16, True, None),
    (64, 64, 2, 2, 16, False, None),
    (128, 128, 2, 2, 16, True, 32),
    (157, 157, 9, 3, 64, True, None),
    (96, 96, 4, 2, 80, True, 32),
    (64, 64, 4, 4, 128, False, None),
    (40, 40, 6, 2, 64, True, 7),
]


def _qkv(b, t, s, h, kh, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32), rng.randn(b, s, kh, d).astype(np.float32),
            rng.randn(b, s, kh, d).astype(np.float32))


@pytest.mark.parametrize("t,s,h,kh,d,causal,window", FLASH_CASES)
def test_flash_plain_matches_reference_kernel_and_layers(t, s, h, kh, d, causal, window):
    q, k, v = _qkv(2, t, s, h, kh, d, seed=t + d)
    got = ops.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  causal=causal, window=window).numpy()
    pallas = np.asarray(jflash.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
        q_block=32, k_block=32, interpret=True))
    layer = np.asarray(jax.jit(lambda a, b_, c: jlayers.flash_attention(
        a, b_, c, causal=causal, window=window, q_block=32, k_block=32))(q, k, v))
    assert got.shape == q.shape
    np.testing.assert_allclose(got, pallas, atol=3e-5, rtol=2e-4)
    np.testing.assert_allclose(got, layer, atol=3e-5, rtol=2e-4)


def test_flash_plain_masks_ragged_lengths_like_the_reference_kernel():
    """S != T and a query longer than the keys: the Pallas kernel's k < S and
    q < T masks, with a window that leaves the last rows no key at all (the
    1e-20 clamp gives them zeros, as in the reference)."""
    q, k, v = _qkv(1, 70, 33, 4, 1, 8, seed=11)
    got = ops.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  causal=True, window=5).numpy()
    pallas = np.asarray(jflash.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=5,
        q_block=16, k_block=16, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=3e-5, rtol=2e-4)
    assert np.all(got[:, 40:] == 0.0)  # rows 40.. see no key within the window


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers check before they launch: CPU tensors, wrong dtypes
    and head dims outside the kernel's range raise instead of reaching it."""
    x = torch.zeros(2, 16)
    codes = torch.zeros(8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mm_kernel.dequant_matmul(x, codes, torch.ones(8))
    with pytest.raises(ValueError, match="bits"):
        mm_kernel.dequant_matmul_packed(x, codes.view(torch.uint8), torch.ones(8), bits=8, k=16)
    q = torch.zeros(1, 4, 2, 64)
    kv = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_kernel.flash_attention_fwd(q, kv, kv)
    for bad_d in (12, 136):
        with pytest.raises(ValueError, match="head dim"):
            flash_kernel.flash_attention_fwd(torch.zeros(1, 4, 2, bad_d),
                                             torch.zeros(1, 4, 1, bad_d),
                                             torch.zeros(1, 4, 1, bad_d))
    with pytest.raises(ValueError, match="kv heads"):
        flash_kernel.flash_attention_fwd(torch.zeros(1, 4, 3, 64), torch.zeros(1, 4, 2, 64),
                                         torch.zeros(1, 4, 2, 64))
