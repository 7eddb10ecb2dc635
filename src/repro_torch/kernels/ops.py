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
keys (``dequant_gather_packed``, ``sparse_row_update_packed``) because they
are their own kernels here.

A caller that decides *before* a wrapper not to use a kernel (the
eligibility gate of ``core.lpt.sparse_apply``) records that choice with
:func:`note_fallback`, keyed ``(op, shape, reason)`` as the reference's
``ops.py:141``; :func:`fallbacks` lists them, so the choice is never silent.
"""
from __future__ import annotations

import collections
import logging

import torch

from repro_torch.core.codestore import CodeStore
from repro_torch.kernels import _build, ref
from repro_torch.kernels import adam_update as _adam
from repro_torch.kernels import dequant_gather as _gather
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


def sr_round(w: torch.Tensor, step: torch.Tensor, noise: torch.Tensor, bits: int = 8,
             *, use_kernel: bool = True) -> torch.Tensor:
    """Fused clip + stochastic round to int8 codes (Eq. 1/4)."""
    if _plain(w, use_kernel):
        return ref.sr_round_ref(w, step, noise, bits)
    return _sr_round.sr_round(w, step, noise, bits)


def dequant_gather(codes, step: torch.Tensor, ids: torch.Tensor, *,
                   use_kernel: bool = True) -> torch.Tensor:
    """f32 [b, d] de-quantized rows for flat int32 ``ids`` [b].

    ``codes`` is a :class:`CodeStore` (packed stores take the packed kernel)
    or a raw int8 [n, d] tensor.
    """
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
    with no scratch row) steps the clamped row and writes nothing, its
    ``w_new`` row finite but unspecified.  ``lr``, ``c1 = 1 - b1^t`` and
    ``c2 = 1 - b2^t`` are float32 host scalars.
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
