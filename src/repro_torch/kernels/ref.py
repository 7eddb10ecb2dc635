"""Plain PyTorch versions of the port's kernels (port of repro/kernels/ref.py).

Each function repeats its kernel's arithmetic in the same operation order as
the reference's jnp oracle, so the CUDA kernel, this version and the JAX
package agree bitwise on the same operands.  :mod:`repro_torch.kernels.ops`
runs these for tensors on the CPU; ``chip_smoke.py`` holds each kernel
against them on the card.

Where XLA:CPU compiles the reference's multiply-adds into fused
multiply-adds (one rounding), these versions call :func:`fma`, which rounds
once as ``__fmaf_rn`` does on the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.codestore import in_range_rows, pack_codes, unpack_codes


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in float64)."""
    return float(np.float32(x))


# Adam constants as the reference's kernel sees them: JAX rounds each Python
# float (``1.0 - b1`` is computed in float64 first) to float32 once.
B1, B2, EPS = f32(0.9), f32(0.999), f32(1e-8)
A1, A2 = f32(1.0 - 0.9), f32(1.0 - 0.999)


def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``like``'s device.  Divide by this, not
    by a Python float: on CUDA, PyTorch computes ``t / python_float`` as ``t *
    (1 / x)``, which is not the correctly rounded quotient."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


#: Elements per pass of the float64 helpers over a large operand: their
#: temporaries are float64 and several, so a table-sized operand (an LM
#: vocab table, an MoE expert stack) goes in chunks of this many.
_CHUNK = 1 << 24


def _chunked(fn, *operands) -> torch.Tensor:
    """``fn(*operands)``, an elementwise float32 function, over chunks of
    :data:`_CHUNK` elements when the tensor operands share one shape larger
    than that (elementwise, so the same bits); whole otherwise (scalars and
    broadcasts)."""
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    shape = tensors[0].shape
    if tensors[0].numel() <= _CHUNK or any(x.shape != shape for x in tensors):
        return fn(*operands)
    out = torch.empty(shape, dtype=torch.float32, device=tensors[0].device)
    flat = out.view(-1)
    parts = [x.reshape(-1) if isinstance(x, torch.Tensor) else x for x in operands]
    for i in range(0, flat.numel(), _CHUNK):
        flat[i:i + _CHUNK] = fn(*(x[i:i + _CHUNK] if isinstance(x, torch.Tensor) else x
                                  for x in parts))
    return out


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (``__fsqrt_rn``).  PyTorch's CPU
    ``sqrt`` on float32 can miss by an ulp; the square root of the float64
    value, rounded to float32, cannot."""
    return _chunked(_sqrt_rn, x)


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as ``__fmaf_rn`` (and a multiply-add
    that XLA:CPU contracts) computes it.

    The product of two float32 values is exact in float64; the sum is made
    exact by TwoSum and rounded to odd, so the final rounding to float32 is
    the only one that counts.  Scalars must already be float32 values.
    """
    return _chunked(_fma, a, b, c)


def _fma(a, b, c) -> torch.Tensor:
    t = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (torch.as_tensor(x, dtype=torch.float64, device=t.device)
               if not isinstance(x, torch.Tensor) else x.to(torch.float64)
               for x in (a, b, c))
    p = a * b
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    even = (s.view(torch.int64) & 1) == 0
    nudge = (err != 0) & even & torch.isfinite(s)
    s = torch.where(nudge, torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf), err)), s)
    return s.to(torch.float32)


def dequant_gather_ref(codes: torch.Tensor, step: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """``out[b] = f32(codes[ids[b]]) * step[ids[b]]`` -> f32 [b, d]."""
    rows = codes.index_select(0, ids).to(torch.float32)
    return rows * step.index_select(0, ids)[:, None]


def dequant_gather_packed_ref(packed: torch.Tensor, step: torch.Tensor,
                              ids: torch.Tensor, *, bits: int, d: int) -> torch.Tensor:
    """The same gather over a packed uint8 container ``[n, ceil(d*bits/8)]``."""
    rows = unpack_codes(packed.index_select(0, ids), bits, d).to(torch.float32)
    return rows * step.index_select(0, ids)[:, None]


def routed_rows(backing: torch.Tensor, hot: torch.Tensor, slot: torch.Tensor,
                row: torch.Tensor) -> torch.Tensor:
    """Container rows ``hot[slot]`` where ``slot >= 0``, else ``backing[row]``:
    how a table behind a hot-row cache (``repro_torch.storage``) addresses a
    row (the reference's where-merge, ``repro/storage/tiered.py:107``)."""
    hot_rows = hot.index_select(0, torch.clamp(slot.to(torch.int64), min=0))
    if not backing.shape[0]:  # a staged wave that missed nothing
        return hot_rows
    return torch.where((slot >= 0)[:, None], hot_rows,
                       backing.index_select(0, row.to(torch.int64)))


def _route(slots: torch.Tensor, ids: torch.Tensor, staged: bool):
    """(slot, backing row) per lookup: through the map, or staged (a slot
    < 0 names staged row ``-1 - slot``)."""
    if staged:
        return slots, torch.clamp(-1 - slots.to(torch.int64), min=0)
    return slots.index_select(0, ids.to(torch.int64)), ids


def dequant_gather_routed_ref(backing: torch.Tensor, hot: torch.Tensor, slots: torch.Tensor,
                              step: torch.Tensor, ids: torch.Tensor, *,
                              staged: bool = False) -> torch.Tensor:
    """:func:`dequant_gather_ref` of the rows :func:`routed_rows` addresses:
    through the map ``slots`` = ``slot_of_id`` [n] (backing row = id), or
    ``staged`` (``slots`` one per lookup; backing row ``-1 - slot`` of the
    staged rows where ``slot < 0``)."""
    rows = routed_rows(backing, hot, *_route(slots, ids, staged)).to(torch.float32)
    return rows * step.index_select(0, ids)[:, None]


def dequant_gather_packed_routed_ref(backing: torch.Tensor, hot: torch.Tensor,
                                     slots: torch.Tensor, step: torch.Tensor, ids: torch.Tensor,
                                     *, bits: int, d: int, staged: bool = False) -> torch.Tensor:
    """The same over packed uint8 containers."""
    rows = unpack_codes(routed_rows(backing, hot, *_route(slots, ids, staged)), bits, d)
    return rows.to(torch.float32) * step.index_select(0, ids)[:, None]


def dequant_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                       step: torch.Tensor) -> torch.Tensor:
    """``x @ (f32(codes) * step[:, None]).T`` -> f32 [M, N] (the LM head over
    the de-quantized table, as the reference's ``dequant_matmul_ref``)."""
    w = codes.to(torch.float32) * step[:, None]
    return x.to(torch.float32) @ w.T


def dequant_matmul_packed_ref(x: torch.Tensor, packed: torch.Tensor, step: torch.Tensor, *,
                              bits: int, k: int) -> torch.Tensor:
    """The same head over a packed uint8 container ``[N, ceil(k*bits/8)]``."""
    return dequant_matmul_ref(x, unpack_codes(packed, bits, k), step)


#: The Pallas kernel's masked score (``kernels/flash_attention.py:29`` there).
NEG_INF = -1e30


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, window: int | None = None,
                            softmax_scale: float | None = None) -> torch.Tensor:
    """Attention q [B, T, H, D], k/v [B, S, KH, D] -> [B, T, H, D] as one masked
    softmax over all keys, with the Pallas kernel's mask semantics: key
    ``k < S``, causal ``q >= k``, window ``q - k < window``, masked scores
    ``NEG_INF``, masked probabilities 0, the denominator clamped at 1e-20;
    query head ``h`` reads kv head ``h // (H / KH)``."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    kr = k.to(torch.float32).repeat_interleave(h // kh, dim=2)
    vr = v.to(torch.float32).repeat_interleave(h // kh, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32) * f32(scale), kr)
    q_ids = torch.arange(t, device=q.device)[:, None]
    k_ids = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_ids >= k_ids
    if window is not None:
        mask &= q_ids - k_ids < window
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    denom = torch.clamp_min(p.sum(dim=-1), 1e-20)
    o = torch.einsum("bhts,bshd->bthd", p, vr)
    return o / denom.permute(0, 2, 1)[..., None]


def sr_round_ref(w: torch.Tensor, step: torch.Tensor, noise: torch.Tensor,
                 bits: int) -> torch.Tensor:
    """``clip(floor(s) + [s - floor(s) > u], lo, hi)`` with ``s = clip(w/step_row)``."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    scaled = torch.clamp(w.to(torch.float32) / step[:, None], lo, hi)
    base = torch.floor(scaled)
    up = (scaled - base > noise).to(torch.float32)
    return torch.clamp(base + up, lo, hi).to(torch.int8)


def lpt_fused_update_ref(codes: torch.Tensor, step: torch.Tensor, upd: torch.Tensor,
                         noise: torch.Tensor, lr: float, bits: int, *,
                         new_step: torch.Tensor | None = None,
                         weight_decay: float = 0.0) -> torch.Tensor:
    """Eq. 8's dense write-back -> int8 codes [R, C]: de-quantize the int8
    ``codes`` with ``step`` [R], take the (decayed) step along the formed
    direction ``upd`` [R, C], SR re-quantize with ``new_step`` (default
    ``step``) and ``noise`` [R, C].

    The arithmetic is the reference's ``lpt_fused_update`` as XLA:CPU
    compiles it, interpreted or jitted (the two agree): without decay
    ``w' = fma(code, Delta, -(lr * upd))``; with decay ``upd' = fma(wd, w,
    upd)``, ``w' = fma(-lr, upd', w)`` with ``w = code * Delta`` — the row
    step's contraction (:func:`adam_row_step`).  ``lr`` is rounded to float32.
    """
    lr = f32(lr)
    cf = codes.to(torch.float32)
    st = step[:, None]
    if weight_decay:
        w = cf * st
        w_new = fma(-lr, fma(f32(weight_decay), w, upd.to(torch.float32)), w)
    else:
        w_new = fma(cf, st, -(lr * upd.to(torch.float32)))
    return sr_round_ref(w_new, step if new_step is None else new_step, noise, bits)


def lpt_fused_update_packed_ref(packed: torch.Tensor, step: torch.Tensor, upd: torch.Tensor,
                                noise: torch.Tensor, lr: float, bits: int, d: int, *,
                                new_step: torch.Tensor | None = None,
                                weight_decay: float = 0.0) -> torch.Tensor:
    """The same write-back over a packed uint8 container ``[R, ceil(d*bits/8)]``:
    ``pack(lpt_fused_update_ref(unpack(packed)))``, new bytes."""
    codes = lpt_fused_update_ref(unpack_codes(packed, bits, d), step, upd, noise, lr, bits,
                                 new_step=new_step, weight_decay=weight_decay)
    return pack_codes(codes, bits)


# Philox4x32-10 (Salmon et al., SC'11): the multipliers and Weyl key increments.
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` 32-bit halves of the 64-bit product of uint32 values
    ``a`` (held in int64) and the constant ``m``.  ``a * m`` can reach 2^64
    and overflow int64, so ``a`` is split at bit 16: each partial product
    stays below 2^48."""
    x = (a & 0xFFFF) * m  # a_lo * m
    y = (a >> 16) * m  # a_hi * m; a * m = y * 2^16 + x
    mid = x + ((y & 0xFFFF) << 16)  # < 2^49
    return (y >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter: list, key: tuple[int, int]) -> list:
    """Philox4x32-10 on four int64 tensors of uint32 counter words and a
    two-word key -> the four output words (int64 tensors of uint32 values),
    as Random123 and the CUDA kernel compute them."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & _MASK32, (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo32(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def philox_uniform(seed: int, n: int, device=None) -> torch.Tensor:
    """``n`` uniforms in [0, 1) (f32) of ``sr_round_seeded``: element ``i``
    takes word ``i % 4`` of Philox4x32-10 at counter ``(i // 4)`` (two low
    words; the high two are 0) under key ``(seed mod 2^32, 0)``, and
    ``u = (word >> 8) * 2^-24`` from the word's top 24 bits as an unsigned
    integer, so u is a multiple of 2^-24 in [0, 1)."""
    groups = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    words = philox4x32_10([groups & _MASK32, groups >> 32, zero, zero],
                          (int(seed) & _MASK32, 0))
    flat = torch.stack(words, dim=1).reshape(-1)[:n]
    return (flat >> 8).to(torch.float32) * f32(2.0 ** -24)


def sr_round_seeded_ref(w: torch.Tensor, step: torch.Tensor, seed: int,
                        bits: int) -> torch.Tensor:
    """:func:`sr_round_ref` with the noise drawn from :func:`philox_uniform`
    over the flat row-major index of ``w`` [r, c]."""
    noise = philox_uniform(seed, w.numel(), w.device).reshape(w.shape)
    return sr_round_ref(w, step, noise, bits)


def adam_direction(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, c1: float,
                   c2: float, *, mu_from_numerator: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bias-corrected Adam direction -> ``(upd, mu', nu')`` for f32 gradients
    ``g``, at ``c1 = 1 - b1^t`` and ``c2 = 1 - b2^t`` (rounded to float32).

    The reference's ``(mu'/c1) / (sqrt(nu'/c2) + eps)`` as XLA:CPU compiles
    it: ``nu' = fma(b2, nu, (1-b2) g^2)``, and the quotient is ``mu'' / (c1 *
    (sqrt(nu'/c2) + eps))`` with ``mu'' = fma(1-b1, g, b1 mu)``.  Which
    contraction XLA stores as ``mu'`` depends on the fusion around it: the
    other one, ``fma(b1, mu, (1-b1) g)``, in the sparse row kernel's body and
    in ALPT's ``dense_weight_update``; ``mu''`` itself (``mu_from_numerator``)
    in ``lpt.dense_apply``, whose new moments feed only the where-merge.
    """
    c1, c2 = f32(c1), f32(c2)
    num = fma(A1, g, B1 * mu)
    mu_new = num if mu_from_numerator else fma(B1, mu, A1 * g)
    nu_new = fma(B2, nu, A2 * (g * g))
    upd = num / (c1 * (sqrt_rn(nu_new / scalar(c2, g)) + EPS))
    return upd, mu_new, nu_new


def adam_row_step(codes: torch.Tensor, step_rows: torch.Tensor, mu: torch.Tensor,
                  nu: torch.Tensor, g: torch.Tensor, lr: float, c1: float, c2: float,
                  weight_decay: float = 0.0, *, mu_from_numerator: bool = False):
    """One row-Adam step on de-quantized rows -> ``(w_new, mu', nu')``.

    ``codes`` f32 [k, d] (the integer codes as floats), ``step_rows`` [k];
    ``lr``, ``c1 = 1 - b1^t`` and ``c2 = 1 - b2^t`` are rounded to float32.  The
    arithmetic is the reference kernel body (``repro/kernels/sparse_row_update.py
    :51-58``) as XLA:CPU compiles it, which is where the reference's numbers
    come from: :func:`adam_direction` (``mu_from_numerator`` as there), then
    the final subtraction fused too.
    """
    lr = f32(lr)  # the kernel takes it as float32
    w = codes * step_rows[:, None]
    upd, mu_new, nu_new = adam_direction(g, mu, nu, c1, c2,
                                         mu_from_numerator=mu_from_numerator)
    if weight_decay:
        upd = fma(f32(weight_decay), w, upd)
        w_new = fma(-lr, upd, w)
    else:
        w_new = fma(codes, step_rows[:, None], -(lr * upd))
    return w_new, mu_new, nu_new


def sparse_row_update_ref(codes: torch.Tensor, step: torch.Tensor, mu: torch.Tensor,
                          nu: torch.Tensor, uniq: torch.Tensor, g_sum: torch.Tensor,
                          noise: torch.Tensor, lr: float, c1: float, c2: float, bits: int,
                          *, weight_decay: float = 0.0) -> torch.Tensor:
    """The fused CTR row step over int8 ``codes`` [N, d]: gather, Adam, SR, scatter.

    **In place**: ``codes``, ``mu`` and ``nu`` rows at ``uniq`` are written
    with ``index_copy_`` (the reference's aliased outputs allow it); returns
    ``w_new`` f32 [K, d].  An id outside ``[0, N)`` (the dedup sentinel of a
    table with no scratch row) steps the clamped row and writes nothing, as
    the reference's ``mode="drop"`` scatter; duplicate in-range ids (the
    sentinel's scratch row) leave that row's bytes unspecified, as the
    reference says of its scratch row.
    """
    safe = _clamped(uniq, codes.shape[0])
    w_new, codes_rows, mu_rows, nu_rows = _row_step(
        codes.index_select(0, safe), step, mu, nu, safe, g_sum, noise, lr, c1, c2, bits,
        weight_decay)
    for t, rows in ((codes, codes_rows), (mu, mu_rows), (nu, nu_rows)):
        t.index_copy_(0, *in_range_rows(uniq, rows, t.shape[0]))
    return w_new


def sparse_row_update_packed_ref(packed: torch.Tensor, step: torch.Tensor, mu: torch.Tensor,
                                 nu: torch.Tensor, uniq: torch.Tensor, g_sum: torch.Tensor,
                                 noise: torch.Tensor, lr: float, c1: float, c2: float,
                                 bits: int, d: int, *, weight_decay: float = 0.0) -> torch.Tensor:
    """The same step over a packed uint8 container ``[N, ceil(d*bits/8)]``:
    rows are unpacked, stepped as above and re-packed in place."""
    safe = _clamped(uniq, packed.shape[0])
    w_new, codes_rows, mu_rows, nu_rows = _row_step(
        unpack_codes(packed.index_select(0, safe), bits, d), step, mu, nu, safe, g_sum,
        noise, lr, c1, c2, bits, weight_decay)
    for t, rows in ((packed, pack_codes(codes_rows, bits)), (mu, mu_rows), (nu, nu_rows)):
        t.index_copy_(0, *in_range_rows(uniq, rows, t.shape[0]))
    return w_new


def segment_sum(values: torch.Tensor, inv: torch.Tensor, k: int) -> torch.Tensor:
    """``out[inv[i]] += values[i]`` into zeros [k, ...], in occurrence order.

    The reference's ``zeros.at[inv].add(g)`` adds each slot's occurrences in
    order, one rounding each, from +0.0.  On the CPU ``index_add_`` walks the
    indices in order.  On the card ``index_add_`` uses atomics, whose order
    changes from run to run; ``index_put_(accumulate=True)`` instead sorts
    the indices with a stable radix sort and adds each slot's run
    sequentially, which is the same order and deterministic
    (``chip_smoke.py`` holds it bitwise against the CPU).
    """
    out = torch.zeros((k, *values.shape[1:]), dtype=values.dtype, device=values.device)
    if out.device.type == "cpu":
        return out.index_add_(0, inv, values)
    return out.index_put_((inv,), values, accumulate=True)


def runs_sum(g_occ: torch.Tensor, order: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """f32 [k, d] with row s the sum of ``g_occ[order[starts[s]:starts[s + 1]]]``
    in that order, from +0.0 (an empty run sums to zeros): the sum the runs
    kernel forms, by :func:`segment_sum` of the lookups in ``order``."""
    m = order.numel()
    slot = torch.searchsorted(starts, torch.arange(m, dtype=starts.dtype, device=starts.device),
                              right=True) - 1
    return segment_sum(g_occ.index_select(0, order.to(torch.int64)), slot.to(torch.int64),
                       starts.numel() - 1)


def sparse_row_update_runs_ref(codes: torch.Tensor, step: torch.Tensor, mu: torch.Tensor,
                               nu: torch.Tensor, uniq: torch.Tensor, g_occ: torch.Tensor,
                               order: torch.Tensor, starts: torch.Tensor, noise: torch.Tensor,
                               lr: float, c1: float, c2: float, bits: int, *,
                               weight_decay: float = 0.0) -> torch.Tensor:
    """:func:`sparse_row_update_ref` of the runs' sums (:func:`runs_sum`):
    the row step over per-lookup gradients ``g_occ`` [m, d], slot s's run
    being ``order[starts[s]:starts[s + 1]]``."""
    return sparse_row_update_ref(codes, step, mu, nu, uniq, runs_sum(g_occ, order, starts),
                                 noise, lr, c1, c2, bits, weight_decay=weight_decay)


def sparse_row_update_runs_packed_ref(packed: torch.Tensor, step: torch.Tensor,
                                      mu: torch.Tensor, nu: torch.Tensor, uniq: torch.Tensor,
                                      g_occ: torch.Tensor, order: torch.Tensor,
                                      starts: torch.Tensor, noise: torch.Tensor, lr: float,
                                      c1: float, c2: float, bits: int, d: int, *,
                                      weight_decay: float = 0.0) -> torch.Tensor:
    """:func:`sparse_row_update_runs_ref` over a packed uint8 container."""
    return sparse_row_update_packed_ref(packed, step, mu, nu, uniq,
                                        runs_sum(g_occ, order, starts), noise, lr, c1, c2, bits,
                                        d, weight_decay=weight_decay)


def sparse_row_update_runs_routed_ref(backing: torch.Tensor, hot: torch.Tensor,
                                      slot_of_id: torch.Tensor, step: torch.Tensor,
                                      mu: torch.Tensor, nu: torch.Tensor, uniq: torch.Tensor,
                                      g_occ: torch.Tensor, order: torch.Tensor,
                                      starts: torch.Tensor, noise: torch.Tensor, lr: float,
                                      c1: float, c2: float, bits: int, *,
                                      packed_d: int | None = None,
                                      weight_decay: float = 0.0) -> torch.Tensor:
    """:func:`sparse_row_update_runs_ref` over a table behind a hot tier: the
    codes of id are ``hot[slot_of_id[id]]`` when cached, ``backing[id]``
    otherwise, read and written there; mu, nu and Delta are indexed by id.
    ``packed_d`` (the logical width) marks packed uint8 containers."""
    n = backing.shape[0]
    safe = _clamped(uniq, n)
    slot = slot_of_id.index_select(0, safe)
    rows = routed_rows(backing, hot, slot, safe)
    if packed_d is not None:
        rows = unpack_codes(rows, bits, packed_d)
    w_new, codes_rows, mu_rows, nu_rows = _row_step(
        rows, step, mu, nu, safe, runs_sum(g_occ, order, starts), noise, lr, c1, c2, bits,
        weight_decay)
    if packed_d is not None:
        codes_rows = pack_codes(codes_rows, bits)
    keep = (uniq >= 0) & (uniq < n)
    cached = keep & (slot >= 0)
    hot.index_copy_(0, slot[cached].to(torch.int64), codes_rows[cached])
    back = keep & (slot < 0)
    backing.index_copy_(0, uniq[back].to(torch.int64), codes_rows[back])
    for t, r in ((mu, mu_rows), (nu, nu_rows)):
        t.index_copy_(0, *in_range_rows(uniq, r, n))
    return w_new


def _clamped(uniq: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(uniq.to(torch.int64), 0, n - 1)


def _row_step(codes_rows, step, mu, nu, safe, g_sum, noise, lr, c1, c2, bits, weight_decay):
    step_rows = step.index_select(0, safe)
    w_new, mu_rows, nu_rows = adam_row_step(
        codes_rows.to(torch.float32), step_rows, mu.index_select(0, safe),
        nu.index_select(0, safe), g_sum.to(torch.float32), lr, c1, c2, weight_decay)
    return w_new, sr_round_ref(w_new, step_rows, noise, bits), mu_rows, nu_rows


def adam_update_ref(params, grads, mu, nu, lr: float, bc1: float, bc2: float, *,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.0, inplace: bool = False):
    """One AdamW step over lists of tensors -> ``(new_params, new_mu, new_nu)``,
    new tensors throughout, or (``inplace``) each tensor's result copied into
    ``params`` / ``mu`` / ``nu`` as it is computed, which are returned.
    ``lr``, ``bc1 = 1 - b1^t`` and ``bc2 = 1 - b2^t`` are float32 values.

    The reference's ``optim/adam.py`` update as XLA:CPU compiles it inside
    the jitted train step: the moment updates and the parameter step are
    fused multiply-adds, and the quotient is ``m' / (bc1 * (sqrt(v' / bc2) +
    eps))``.
    """
    lr, bc1, bc2 = f32(lr), f32(bc1), f32(bc2)
    B1_, A1_, B2_, A2_ = f32(b1), f32(1.0 - b1), f32(b2), f32(1.0 - b2)
    new_p, new_m, new_v = [], [], []
    for p, g, m_in, v_in in zip(params, grads, mu, nu):
        g32 = g.to(torch.float32)
        m = fma(B1_, m_in, A1_ * g32)
        v = fma(B2_, v_in, A2_ * (g32 * g32))
        update = m / (bc1 * (sqrt_rn(v / scalar(bc2, v)) + f32(eps)))
        p32 = p.detach().to(torch.float32)
        if weight_decay:
            update = fma(f32(weight_decay), p32, update)
        p_new = fma(-lr, update, p32).to(p.dtype)
        if inplace:
            p_new, m, v = p.detach().copy_(p_new), m_in.copy_(m), v_in.copy_(v)
        new_p.append(p_new)
        new_m.append(m)
        new_v.append(v)
    return new_p, new_m, new_v
