"""Why the flash kernel's products take three TF32 terms: a numpy model of
its arithmetic against the plain fp32 attention, on the CPU.

The CUDA ``flash_attention_fwd`` (``csrc/flash_attention.cu``) runs both
inner products, ``(scale q) K^T`` and ``P V``, on the tensor cores as
3xTF32: each operand is split as ``hi = rna_tf32(x)``, ``lo = rna_tf32(x -
hi)`` and a product is ``a_hi b_lo + a_lo b_hi + a_hi b_hi`` summed in fp32.
This file models that (``cvt.rna.tf32`` as ``(bits + 0x1000) & 0xffffe000``
on the fp32 bit pattern; the products of TF32 values are exact in fp32) with
the kernel's online softmax over 32-key tiles and its fold of warp groups,
and holds it against ``ref.flash_attention_fwd_ref`` at ``chip_smoke.py``'s
attention shapes:

* three products land within ``FLASH_ATOL / 10`` (``FLASH_ATOL = 1e-4`` is
  the kernel's tolerance against the plain version on the card);
* one TF32 product misses ``FLASH_ATOL`` at SmolLM's prefill shape, which is
  why the kernel pays for three.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

FLASH_ATOL = 1e-4
# chip_smoke.py's FLASH_CASES: (B, T, S, H, KH, D, causal, window).
FLASH_CASES = [(1, 157, 157, 9, 3, 64, True, None), (2, 96, 96, 4, 2, 80, True, 32),
               (1, 64, 64, 4, 4, 128, False, None), (1, 2048, 2048, 9, 3, 64, True, None)]
BK = 32  # keys per kv tile


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: fp32 rounded to 10 explicit mantissa bits, ties away."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def matmul_tf32(a: np.ndarray, b: np.ndarray, products: int) -> np.ndarray:
    """a @ b in fp32 from TF32 products: 3 (hi lo + lo hi + hi hi) or 1."""
    a_hi, b_hi = rna_tf32(a), rna_tf32(b)
    if products == 1:
        return a_hi @ b_hi
    a_lo, b_lo = rna_tf32(a - a_hi), rna_tf32(b - b_hi)
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def fold(x, y):
    """Merge two parts (o, m, l) of the same rows' keys."""
    (o1, m1, l1), (o2, m2, l2) = x, y
    m = np.maximum(m1, m2)
    f1, f2 = np.exp(m1 - m), np.exp(m2 - m)
    return o1 * f1 + o2 * f2, m, l1 * f1 + l2 * f2


def flash_model(q, k, v, *, causal, window, products=3, groups=1):
    """The kernel's arithmetic: online softmax over 32-key tiles, tile j to
    warp group j % groups, the groups folded in order; float32 throughout."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qi = np.arange(t)[:, None]
    out = np.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            qs = q[bi, :, hi] * np.float32(1.0 / math.sqrt(d))
            kk, vv = k[bi, :, hi // g], v[bi, :, hi // g]
            parts = [(np.zeros((t, d), np.float32), np.full((t, 1), ref.NEG_INF, np.float32),
                      np.zeros((t, 1), np.float32)) for _ in range(groups)]
            for j, k0 in enumerate(range(0, s, BK)):
                kj = np.arange(k0, min(k0 + BK, s))[None, :]
                vis = np.ones((t, kj.shape[1]), bool)
                if causal:
                    vis &= qi >= kj
                if window is not None:
                    vis &= qi - kj < window
                sc = np.where(vis, matmul_tf32(qs, kk[k0:k0 + BK].T, products), ref.NEG_INF)
                o, m, l = parts[j % groups]
                m_new = np.maximum(m, sc.max(axis=1, keepdims=True))
                alpha = np.exp(m - m_new)
                p = np.where(m_new != ref.NEG_INF, np.exp(sc - m_new), 0.0).astype(np.float32)
                parts[j % groups] = (o * alpha + matmul_tf32(p, vv[k0:k0 + BK], products),
                                     m_new, l * alpha + p.sum(axis=1, keepdims=True))
            o, _, l = parts[0]
            for part in parts[1:]:
                o, _, l = fold((o, _, l), part)
            out[bi, :, hi] = o / np.maximum(l, np.float32(1e-20))
    return out


def _qkv(b, t, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, d), dtype=np.float32),
            rng.standard_normal((b, s, kh, d), dtype=np.float32),
            rng.standard_normal((b, s, kh, d), dtype=np.float32))


def _plain(q, k, v, causal, window):
    return ref.flash_attention_fwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal,
                                       window=window).numpy()


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's unit in the last place at 1
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 + 2.0 ** -12,
                  -(1.0 + 2.0 ** -11), 3.0e-39], dtype=np.float32)
    got = rna_tf32(x)
    np.testing.assert_array_equal(got[:5], [one, one + ulp, one + ulp, one, -(one + ulp)])
    assert (got.view(np.uint32) & 0x1FFF == 0).all()  # 13 low bits clear, subnormals too


@pytest.mark.parametrize("b,t,s,h,kh,d,causal,window", FLASH_CASES)
def test_three_tf32_products_hold_the_plain_attention(b, t, s, h, kh, d, causal, window):
    q, k, v = _qkv(b, t, s, h, kh, d, seed=t + d)
    err = np.abs(flash_model(q, k, v, causal=causal, window=window) -
                 _plain(q, k, v, causal, window)).max()
    assert err <= FLASH_ATOL / 10, err


def test_warp_groups_fold_to_the_same_attention():
    """SmolLM's prefill as the kernel runs it at T = 157: the 5 kv tiles of
    the longest query tile over 5 warp groups, folded in group order."""
    q, k, v = _qkv(1, 157, 157, 9, 3, 64, seed=5)
    one = flash_model(q, k, v, causal=True, window=None)
    five = flash_model(q, k, v, causal=True, window=None, groups=5)
    assert np.abs(five - _plain(q, k, v, True, None)).max() <= FLASH_ATOL / 10
    np.testing.assert_allclose(five, one, atol=2e-6, rtol=0)


def test_one_tf32_product_misses_the_tolerance():
    """Negative control: plain TF32 (10 explicit mantissa bits per operand)
    at SmolLM's prefill shape is off the fp32 attention by more than
    FLASH_ATOL, so the kernel needs the 3-product split."""
    q, k, v = _qkv(1, 157, 157, 9, 3, 64, seed=157 + 64)
    err = np.abs(flash_model(q, k, v, causal=True, window=None, products=1) -
                 _plain(q, k, v, True, None)).max()
    assert err > FLASH_ATOL, err
