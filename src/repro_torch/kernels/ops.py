"""Dispatch for the port's kernels (port of repro/kernels/ops.py).

One rule, with no fallback: a tensor on the CPU takes the kernel's plain
PyTorch version (:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the
hand-written kernel, whose wrapper raises on anything it does not take.
``use_kernel=False`` is the caller's explicit request for the plain version
on any device — the switch ``EmbeddingSpec.use_kernels`` sets, as in the
reference — and is how ``chip_smoke.py`` builds its comparison engine.

Unlike the reference, which falls back (counted) to its jnp oracle on shapes
that are not multiples of 8, the CUDA kernels take every shape, so nothing
here falls back.  :func:`kernel_calls` counts real launches per kernel, in
the shape of the reference's ``fallback_stats()["kernel_calls"]``
(``ops.py:178`` there: op name -> count); the packed variants have their own
keys (``dequant_gather_packed``, ``sparse_row_update_packed``,
``sparse_row_update_runs_packed``, ``dequant_matmul_packed``,
``lpt_fused_update_packed``) because they are their own kernels here, the
row step with the gradient sum folded in counts as
``sparse_row_update_runs``, and the dense write-back counts as
``lpt_fused_update`` (the reference's ``lpt_update``).

The gather, head and attention kernels are forward only: their CUDA
wrappers return a tensor autograd never sees, while their plain versions
are differentiable.  So those dispatchers raise, on every device, when grad
mode is on and a floating input requires grad (:func:`_forward_only`): a
training forward that reaches one fails on the CPU too, instead of losing
its gradient on the card.  Serving runs them under ``inference_mode``.

A caller that decides *before* a wrapper not to use a kernel (the
eligibility gate of ``core.lpt.sparse_apply``) records that choice with
:func:`note_fallback`, keyed ``(op, shape, reason)`` as the reference's
``ops.py:141``; :func:`fallbacks` lists them, so the choice is never silent.
"""
from __future__ import annotations

import collections
import dataclasses
import logging

import torch

from repro_torch.core.codestore import CodeStore
from repro_torch.kernels import _build, ref
from repro_torch.kernels import adam_update as _adam
from repro_torch.kernels import dequant_gather as _gather
from repro_torch.kernels import dequant_matmul as _matmul
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import lpt_update as _lpt
from repro_torch.kernels import sparse_row_update as _row_update
from repro_torch.kernels import sr_round as _sr_round

logger = logging.getLogger(__name__)

#: Counted kernels-on dispatches that took the plain path, by (op, shape, reason).
_FALLBACKS: collections.Counter = collections.Counter()


def kernel_calls() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_kernel_calls`, by kernel."""
    return dict(_build.LAUNCHES)


def reset_kernel_calls() -> None:
    _build.reset_launches()


def note_fallback(op: str, shape, reason: str) -> None:
    """Count a kernels-on dispatch that a caller routed to the plain path;
    warns once per key."""
    key = (op, str(tuple(shape)), reason)
    if not _FALLBACKS[key]:
        logger.warning("kernels.%s: shape %s takes the plain path (%s)", op, tuple(shape), reason)
    _FALLBACKS[key] += 1


def fallbacks() -> list[dict]:
    """Counted fallbacks since the last :func:`reset_fallbacks`, in the
    reference's ``fallback_stats()["fallbacks"]`` schema."""
    return [{"op": op, "shape": shape, "reason": reason, "count": int(c)}
            for (op, shape, reason), c in sorted(_FALLBACKS.items())]


def reset_fallbacks() -> None:
    _FALLBACKS.clear()


def _plain(t: torch.Tensor, use_kernel: bool) -> bool:
    return not use_kernel or t.device.type == "cpu"


def _forward_only(op: str, *tensors) -> None:
    """Raise if ``op``, whose kernel has no backward, would be differentiated."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.is_floating_point() and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"ops.{op} is forward only (its CUDA kernel has no backward), but an input "
            "requires grad with grad mode on; call it under torch.no_grad() or "
            "torch.inference_mode(), or differentiate a plain PyTorch path instead")


def sr_round(w: torch.Tensor, step: torch.Tensor, noise: torch.Tensor, bits: int = 8,
             *, use_kernel: bool = True) -> torch.Tensor:
    """Fused clip + stochastic round to int8 codes (Eq. 1/4)."""
    if _plain(w, use_kernel):
        return ref.sr_round_ref(w, step, noise, bits)
    return _sr_round.sr_round(w, step, noise, bits)


def sr_round_seeded(w: torch.Tensor, step: torch.Tensor, seed: int, bits: int = 8, *,
                    use_kernel: bool = True) -> torch.Tensor:
    """:func:`sr_round` with the uniforms drawn from Philox4x32-10 keyed by the
    int32 ``seed`` (``ref.philox_uniform``), on the card inside the kernel."""
    if _plain(w, use_kernel):
        return ref.sr_round_seeded_ref(w, step, seed, bits)
    return _sr_round.sr_round_seeded(w, step, seed, bits)


def lpt_update(codes, step: torch.Tensor, upd: torch.Tensor, noise: torch.Tensor, lr: float,
               bits: int, *, new_step: torch.Tensor | None = None, weight_decay: float = 0.0,
               use_kernel: bool = True):
    """Fused Eq. 8 write-back: de-quantize -> (decayed) step along the formed
    direction ``upd`` -> SR re-quantize, with ALPT's ``new_step`` when given.

    ``codes`` is a :class:`CodeStore` (returns a new store of the same layout;
    a packed one takes the packed kernel, counted as
    ``lpt_fused_update_packed``) or a raw int8 [R, C] tensor (returns int8).
    ``lr`` and ``weight_decay`` are float32 values.
    """
    kw = dict(new_step=new_step, weight_decay=weight_decay)
    if isinstance(codes, CodeStore):
        if codes.packed:
            if _plain(step, use_kernel):
                data = ref.lpt_fused_update_packed_ref(codes.data, step, upd, noise, lr, bits,
                                                       codes.d, **kw)
            else:
                data = _lpt.lpt_fused_update_packed(codes.data, step, upd, noise, lr, bits,
                                                    codes.d, **kw)
        else:
            data = lpt_update(codes.data, step, upd, noise, lr, bits, use_kernel=use_kernel, **kw)
        return dataclasses.replace(codes, data=data)
    if _plain(step, use_kernel):
        return ref.lpt_fused_update_ref(codes, step, upd, noise, lr, bits, **kw)
    return _lpt.lpt_fused_update(codes, step, upd, noise, lr, bits, **kw)


def dequant_gather(codes, step: torch.Tensor, ids: torch.Tensor, *,
                   use_kernel: bool = True) -> torch.Tensor:
    """f32 [b, d] de-quantized rows for flat int32 ``ids`` [b].

    ``codes`` is a :class:`CodeStore` (packed stores take the packed kernel)
    or a raw int8 [n, d] tensor.  Forward only (:func:`_forward_only`).
    """
    _forward_only("dequant_gather", step)
    if isinstance(codes, CodeStore) and codes.packed:
        if _plain(step, use_kernel):
            return ref.dequant_gather_packed_ref(codes.data, step, ids,
                                                 bits=codes.bits, d=codes.d)
        return _gather.dequant_gather_packed(codes.data, step, ids,
                                             bits=codes.bits, d=codes.d)
    if isinstance(codes, CodeStore):
        codes = codes.data
    if _plain(step, use_kernel):
        return ref.dequant_gather_ref(codes, step, ids)
    return _gather.dequant_gather(codes, step, ids)


def dequant_matmul(x: torch.Tensor, codes, step: torch.Tensor, *,
                   use_kernel: bool = True) -> torch.Tensor:
    """The quantized LM head: f32 [M, N] ``x @ (step[:, None] * codes).T``
    for f32 ``x`` [M, K], the fp32 table never built.

    ``codes`` is a :class:`CodeStore` (packed stores take the packed kernel,
    counted as ``dequant_matmul_packed``) or a raw int8 [N, K] tensor.
    Forward only (:func:`_forward_only`).
    """
    _forward_only("dequant_matmul", x, step)
    if isinstance(codes, CodeStore) and codes.packed:
        if _plain(x, use_kernel):
            return ref.dequant_matmul_packed_ref(x, codes.data, step, bits=codes.bits,
                                                 k=codes.d)
        return _matmul.dequant_matmul_packed(x, codes.data, step, bits=codes.bits, k=codes.d)
    if isinstance(codes, CodeStore):
        codes = codes.data
    if _plain(x, use_kernel):
        return ref.dequant_matmul_ref(x, codes, step)
    return _matmul.dequant_matmul(x, codes, step)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softmax_scale: float | None = None,
                        use_kernel: bool = True) -> torch.Tensor:
    """Attention forward q [B, T, H, D], k/v [B, S, KH, D] -> [B, T, H, D]
    (GQA, causal, sliding window, ragged T and S; fp32).  Forward only
    (:func:`_forward_only`): training attention is
    ``models.layers.flash_attention_train``."""
    _forward_only("flash_attention_fwd", q, k, v)
    if _plain(q, use_kernel):
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                           softmax_scale=softmax_scale)
    return _flash.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      softmax_scale=softmax_scale)


def sparse_row_update(codes, step: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                      uniq: torch.Tensor, g_sum: torch.Tensor, noise: torch.Tensor,
                      lr: float, c1: float, c2: float, bits: int, *,
                      weight_decay: float = 0.0, use_kernel: bool = True) -> torch.Tensor:
    """Fused CTR row step over the unique ids (gather + Adam + SR + scatter).

    **In place**: the rows ``uniq`` of the codes, ``mu`` and ``nu`` are
    rewritten (the reference's outputs alias these inputs); returns the
    updated float rows ``w_new`` f32 [K, d].  ``codes`` is a
    :class:`CodeStore` (packed stores take the packed kernel) or a raw int8
    [N, d] tensor.  An id outside ``[0, N)`` (the dedup sentinel of a table
    with no scratch row) writes nothing, its ``w_new`` row finite but
    unspecified (the kernel writes zeros, the plain version steps the
    clamped row), as is that of a slot whose id repeats the previous slot's.
    ``lr``, ``c1 = 1 - b1^t`` and ``c2 = 1 - b2^t`` are float32 host scalars.
    """
    if isinstance(codes, CodeStore) and codes.packed:
        if _plain(step, use_kernel):
            return ref.sparse_row_update_packed_ref(
                codes.data, step, mu, nu, uniq, g_sum, noise, lr, c1, c2, codes.bits, codes.d,
                weight_decay=weight_decay)
        return _row_update.sparse_row_update_packed(
            codes.data, step, mu, nu, uniq, g_sum, noise, lr, c1, c2, codes.bits, codes.d,
            weight_decay=weight_decay)
    if isinstance(codes, CodeStore):
        codes = codes.data
    if _plain(step, use_kernel):
        return ref.sparse_row_update_ref(codes, step, mu, nu, uniq, g_sum, noise, lr, c1, c2,
                                         bits, weight_decay=weight_decay)
    return _row_update.sparse_row_update(codes, step, mu, nu, uniq, g_sum, noise, lr, c1, c2,
                                         bits, weight_decay=weight_decay)


def sparse_row_update_runs(codes, step: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                           uniq: torch.Tensor, g_occ: torch.Tensor, order: torch.Tensor,
                           starts: torch.Tensor, noise: torch.Tensor, lr: float, c1: float,
                           c2: float, bits: int, *, weight_decay: float = 0.0,
                           use_kernel: bool = True) -> torch.Tensor:
    """:func:`sparse_row_update` with the duplicate-id gradient sum folded in:
    slot s's gradient is the sum, in occurrence order from +0.0, of the
    per-lookup rows ``g_occ[order[starts[s]:starts[s + 1]]]``
    (``core.lpt.dedup_runs``), bitwise what ``core.lpt.segment_sum``
    gives the ``g_sum`` form.  Counted as ``sparse_row_update_runs`` and, for
    packed stores, ``sparse_row_update_runs_packed``.
    """
    args = (g_occ, order, starts, noise, lr, c1, c2)
    if isinstance(codes, CodeStore) and codes.packed:
        if _plain(step, use_kernel):
            return ref.sparse_row_update_runs_packed_ref(
                codes.data, step, mu, nu, uniq, *args, codes.bits, codes.d,
                weight_decay=weight_decay)
        return _row_update.sparse_row_update_runs_packed(
            codes.data, step, mu, nu, uniq, *args, codes.bits, codes.d,
            weight_decay=weight_decay)
    if isinstance(codes, CodeStore):
        codes = codes.data
    if _plain(step, use_kernel):
        return ref.sparse_row_update_runs_ref(codes, step, mu, nu, uniq, *args, bits,
                                              weight_decay=weight_decay)
    return _row_update.sparse_row_update_runs(codes, step, mu, nu, uniq, *args, bits,
                                              weight_decay=weight_decay)


def adam_update(params, grads, mu, nu, lr: float, bc1: float, bc2: float, *,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0, use_kernel: bool = True):
    """One AdamW step over lists of tensors -> ``(new_params, new_mu, new_nu)``
    (the dense optimizer; one launch for the whole list on the card)."""
    if not params or _plain(params[0], use_kernel):
        return ref.adam_update_ref(params, grads, mu, nu, lr, bc1, bc2, b1=b1, b2=b2, eps=eps,
                                   weight_decay=weight_decay)
    return _adam.adam_update(params, grads, mu, nu, lr, bc1, bc2, b1=b1, b2=b2, eps=eps,
                             weight_decay=weight_decay)
