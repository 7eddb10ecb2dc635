"""Dispatch for the port's kernels (port of repro/kernels/ops.py).

One rule, with no fallback: a tensor on the CPU takes the kernel's plain
PyTorch version (:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the
hand-written kernel, whose wrapper raises on anything it does not take.
``use_kernel=False`` is the caller's explicit request for the plain version
on any device — the switch ``EmbeddingSpec.use_kernels`` sets, as in the
reference — and is how ``chip_smoke.py`` builds its comparison engine.

Unlike the reference, which falls back (counted) to its jnp oracle on shapes
that are not multiples of 8, the CUDA kernels take every shape, so nothing
here falls back on its own.  The one exception is asked for: while a fault
plan (:mod:`repro_torch.faults`) naming ``kernels.force_fallback`` is
installed, each dispatcher whose name (or the reference's name for it) is
in the spec's ``ops`` param, all of them when it has none, takes the plain
version on any device, counted with reason ``fault-injected``
(:func:`_fault_forced`); without a plan nothing changes.  :func:`kernel_calls` counts real launches per kernel, in
the shape of the reference's ``fallback_stats()["kernel_calls"]``
(``ops.py:178`` there: op name -> count), read from the obs registry's
``kernels.kernel_calls`` (label ``op``), which ``_build.launch`` increments;
the packed variants have their own
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
``ops.py:141``, in the registry's ``kernels.fallbacks``; :func:`fallbacks`
lists them, so the choice is never silent.  :func:`fallback_stats` gives
both tallies in the reference's legacy schema, and :func:`fallback_scope`
collects them for one ``with`` block (the engine's report), as the
reference's.

A table behind a hot-row cache (:class:`repro_torch.core.tiered.TieredCodes`)
takes routed kernels, counted under their own names: the gathers
(``dequant_gather_routed``, ``dequant_gather_packed_routed``; the reference
routes them at ``ops.py:418``, as a where-merge in jnp) and the runs form
of the row step (``sparse_row_update_runs_routed`` and ``_packed_routed``;
the reference takes a counted jnp fallback there, ``core/lpt.py:263``).
The cold tier's wave gather (:func:`dequant_gather_staged`) is the routed
gather's staged route and counts under the same names.  No other kernel
takes a ``TieredCodes``: :func:`lpt_update`, :func:`dequant_matmul` and the
g_sum form raise on one (no path reaches them with one, the reference has
no LM cache).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging

import torch

from repro_torch.core.codestore import CodeStore
from repro_torch.core.tiered import TieredCodes
from repro_torch.faults import plan as faultplan
from repro_torch.kernels import _build, ref
from repro_torch.kernels import adam_update as _adam
from repro_torch.kernels import dequant_gather as _gather
from repro_torch.kernels import dequant_matmul as _matmul
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import lpt_update as _lpt
from repro_torch.kernels import sparse_row_update as _row_update
from repro_torch.kernels import sr_round as _sr_round
from repro_torch.obs import counters as obs_counters

logger = logging.getLogger(__name__)

#: Counted kernels-on dispatches that took the plain path, by (op, shape, reason).
_MET_FALLBACKS = obs_counters.registry().counter(
    "kernels.fallbacks", "kernels-on dispatches routed to the plain path",
    labels=("op", "shape", "reason"))


class FallbackScope:
    """Launches and noted fallbacks made while the scope is open
    (:func:`fallback_scope`), kept apart from the process-wide tally."""

    def __init__(self) -> None:
        self.kernel_calls: collections.Counter = collections.Counter()
        self.fallbacks: collections.Counter = collections.Counter()

    def stats(self) -> dict:
        return _stats_of(self.kernel_calls, self.fallbacks)


@contextlib.contextmanager
def fallback_scope(scope: FallbackScope | None = None):
    """Collect launches and noted fallbacks for the duration of a ``with``
    block; yields the :class:`FallbackScope` (pass one to re-enter it: the
    engine keeps one across its steps).  Neither clears nor reads the
    process-wide tally."""
    scope = FallbackScope() if scope is None else scope
    _build.SCOPES.append(scope)
    try:
        yield scope
    finally:
        _build.SCOPES.remove(scope)


def _stats_of(kernel_calls, fallback_counts) -> dict:
    return {
        "kernel_calls": dict(kernel_calls),
        "fallbacks": [{"op": op, "shape": shape, "reason": reason, "count": int(c)}
                      for (op, shape, reason), c in sorted(fallback_counts.items())],
        "total_fallbacks": int(sum(fallback_counts.values())),
    }


def kernel_calls() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_kernel_calls`, by kernel."""
    return {op: int(c) for (op,), c in _build.KERNEL_CALLS.cells().items()}


def reset_kernel_calls() -> None:
    _build.KERNEL_CALLS.reset()


def note_fallback(op: str, shape, reason: str) -> None:
    """Count a kernels-on dispatch that a caller routed to the plain path;
    warns once per key."""
    key = (op, str(tuple(shape)), reason)
    if not _MET_FALLBACKS.value(*key):
        logger.warning("kernels.%s: shape %s takes the plain path (%s)", op, tuple(shape), reason)
    _MET_FALLBACKS.inc(1, *key)
    for scope in _build.SCOPES:
        scope.fallbacks[key] += 1


def fallbacks() -> list[dict]:
    """Counted fallbacks since the last :func:`reset_fallbacks`, in the
    reference's ``fallback_stats()["fallbacks"]`` schema."""
    return _stats_of({}, _MET_FALLBACKS.cells())["fallbacks"]


def reset_fallbacks() -> None:
    _MET_FALLBACKS.reset()


def fallback_stats() -> dict:
    """Launches and noted fallbacks since the last resets, in the reference's
    legacy schema: ``{kernel_calls, fallbacks, total_fallbacks}``."""
    return _stats_of(kernel_calls(), _MET_FALLBACKS.cells())


def reset_fallback_stats() -> None:
    reset_kernel_calls()
    reset_fallbacks()


#: The reference's op name for a dispatcher it has under another name, so a
#: ``kernels.force_fallback`` plan written for the reference forces it too.
_REFERENCE_OP = {"sparse_row_update_runs": "sparse_row_update",
                 "dequant_gather_staged": "dequant_gather", "sr_round_seeded": "sr_round"}


def _fault_forced(op: str, shape) -> bool:
    """Whether an installed fault plan forces ``op`` onto its plain version
    (the ``kernels.force_fallback`` seam, the reference's ``_fault_forced``):
    every dispatch while the plan is installed, narrowed to the ops its
    ``ops`` param names (dispatcher names, or the reference's).  Counted
    through :func:`note_fallback` with reason ``fault-injected``.  The
    reference consults the plan at trace time; the port, per dispatch."""
    spec = faultplan.lookup("kernels.force_fallback")
    if spec is None:
        return False
    sel = spec.param("ops")
    if sel is not None and op not in sel and _REFERENCE_OP.get(op) not in sel:
        return False
    note_fallback(op, shape, "fault-injected")
    return True


def _plain(t: torch.Tensor, use_kernel: bool, op: str, shape) -> bool:
    """Take the plain version: asked for (``use_kernel=False``), forced by a
    fault plan (on any device), or a CPU tensor."""
    return not use_kernel or _fault_forced(op, shape) or t.device.type == "cpu"


def _untiered(op: str, codes) -> None:
    """Raise if ``codes`` is a table behind a hot-row cache: ``op`` has no
    routed kernel and no path reaches it with one."""
    if isinstance(codes, TieredCodes):
        raise TypeError(f"ops.{op} takes no TieredCodes (no routed kernel); pass the backing "
                        "with the cache folded in (HotRowCache.unwrap)")


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
    if _plain(w, use_kernel, "sr_round", w.shape):
        return ref.sr_round_ref(w, step, noise, bits)
    return _sr_round.sr_round(w, step, noise, bits)


def sr_round_seeded(w: torch.Tensor, step: torch.Tensor, seed: int, bits: int = 8, *,
                    use_kernel: bool = True) -> torch.Tensor:
    """:func:`sr_round` with the uniforms drawn from Philox4x32-10 keyed by the
    int32 ``seed`` (``ref.philox_uniform``), on the card inside the kernel."""
    if _plain(w, use_kernel, "sr_round_seeded", w.shape):
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
    _untiered("lpt_update", codes)
    kw = dict(new_step=new_step, weight_decay=weight_decay)
    if isinstance(codes, CodeStore):
        if codes.packed:
            if _plain(step, use_kernel, "lpt_update", codes.shape):
                data = ref.lpt_fused_update_packed_ref(codes.data, step, upd, noise, lr, bits,
                                                       codes.d, **kw)
            else:
                data = _lpt.lpt_fused_update_packed(codes.data, step, upd, noise, lr, bits,
                                                    codes.d, **kw)
        else:
            data = lpt_update(codes.data, step, upd, noise, lr, bits, use_kernel=use_kernel, **kw)
        return dataclasses.replace(codes, data=data)
    if _plain(step, use_kernel, "lpt_update", codes.shape):
        return ref.lpt_fused_update_ref(codes, step, upd, noise, lr, bits, **kw)
    return _lpt.lpt_fused_update(codes, step, upd, noise, lr, bits, **kw)


def dequant_gather(codes, step: torch.Tensor, ids: torch.Tensor, *,
                   use_kernel: bool = True) -> torch.Tensor:
    """f32 [b, d] de-quantized rows for flat int32 ``ids`` [b].

    ``codes`` is a :class:`CodeStore` (packed stores take the packed kernel),
    a raw int8 [n, d] tensor, or a :class:`TieredCodes` (the routed kernels:
    a cached row is read from the hot tier).  Forward only
    (:func:`_forward_only`).
    """
    _forward_only("dequant_gather", step)
    plain = _plain(step, use_kernel, "dequant_gather", codes.shape)
    if isinstance(codes, TieredCodes):
        args = (codes.backing.data, codes.hot.data, codes.slot_of_id, step, ids)
        if codes.packed:
            if plain:
                return ref.dequant_gather_packed_routed_ref(*args, bits=codes.bits, d=codes.d)
            return _gather.dequant_gather_packed_routed(*args, bits=codes.bits, d=codes.d)
        if plain:
            return ref.dequant_gather_routed_ref(*args)
        return _gather.dequant_gather_routed(*args)
    if isinstance(codes, CodeStore) and codes.packed:
        if plain:
            return ref.dequant_gather_packed_ref(codes.data, step, ids,
                                                 bits=codes.bits, d=codes.d)
        return _gather.dequant_gather_packed(codes.data, step, ids,
                                             bits=codes.bits, d=codes.d)
    if isinstance(codes, CodeStore):
        codes = codes.data
    if plain:
        return ref.dequant_gather_ref(codes, step, ids)
    return _gather.dequant_gather(codes, step, ids)


def dequant_gather_staged(rows: torch.Tensor, hot: torch.Tensor, slot: torch.Tensor,
                          step: torch.Tensor, ids: torch.Tensor, *, bits: int, d: int,
                          packed: bool, use_kernel: bool = True) -> torch.Tensor:
    """The cold tier's wave gather, f32 [b, d]: lookup i's container row is
    ``hot[slot[i]]`` when ``slot[i] >= 0``, else the staged
    ``rows[-1 - slot[i]]``, scaled by ``step[ids[i]]``; the routed gathers'
    staged route."""
    _forward_only("dequant_gather_staged", step)
    args = (rows, hot, slot, step, ids)
    plain = _plain(step, use_kernel, "dequant_gather_staged", (step.shape[0], d))
    if packed:
        if plain:
            return ref.dequant_gather_packed_routed_ref(*args, bits=bits, d=d, staged=True)
        return _gather.dequant_gather_packed_routed(*args, bits=bits, d=d, staged=True)
    if plain:
        return ref.dequant_gather_routed_ref(*args, staged=True)
    return _gather.dequant_gather_routed(*args, staged=True)


def dequant_matmul(x: torch.Tensor, codes, step: torch.Tensor, *,
                   use_kernel: bool = True) -> torch.Tensor:
    """The quantized LM head: f32 [M, N] ``x @ (step[:, None] * codes).T``
    for f32 ``x`` [M, K], the fp32 table never built.

    ``codes`` is a :class:`CodeStore` (packed stores take the packed kernel,
    counted as ``dequant_matmul_packed``) or a raw int8 [N, K] tensor.
    Forward only (:func:`_forward_only`).
    """
    _forward_only("dequant_matmul", x, step)
    _untiered("dequant_matmul", codes)
    plain = _plain(x, use_kernel, "dequant_matmul", (x.shape[0], *codes.shape))
    if isinstance(codes, CodeStore) and codes.packed:
        if plain:
            return ref.dequant_matmul_packed_ref(x, codes.data, step, bits=codes.bits,
                                                 k=codes.d)
        return _matmul.dequant_matmul_packed(x, codes.data, step, bits=codes.bits, k=codes.d)
    if isinstance(codes, CodeStore):
        codes = codes.data
    if plain:
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
    if _plain(q, use_kernel, "flash_attention_fwd", q.shape):
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
    _untiered("sparse_row_update", codes)
    plain = _plain(step, use_kernel, "sparse_row_update", codes.shape)
    if isinstance(codes, CodeStore) and codes.packed:
        if plain:
            return ref.sparse_row_update_packed_ref(
                codes.data, step, mu, nu, uniq, g_sum, noise, lr, c1, c2, codes.bits, codes.d,
                weight_decay=weight_decay)
        return _row_update.sparse_row_update_packed(
            codes.data, step, mu, nu, uniq, g_sum, noise, lr, c1, c2, codes.bits, codes.d,
            weight_decay=weight_decay)
    if isinstance(codes, CodeStore):
        codes = codes.data
    if plain:
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
    packed stores, ``sparse_row_update_runs_packed``.  A :class:`TieredCodes`
    takes the routed kernel (``..._routed``): a cached row's codes are read
    and written in the hot tier, the others in the backing.
    """
    args = (g_occ, order, starts, noise, lr, c1, c2)
    plain = _plain(step, use_kernel, "sparse_row_update_runs", codes.shape)
    if isinstance(codes, TieredCodes):
        tiers = (codes.backing.data, codes.hot.data, codes.slot_of_id, step, mu, nu, uniq)
        if codes.packed:
            if plain:
                return ref.sparse_row_update_runs_routed_ref(
                    *tiers, *args, codes.bits, packed_d=codes.d, weight_decay=weight_decay)
            return _row_update.sparse_row_update_runs_packed_routed(
                *tiers, *args, codes.bits, codes.d, weight_decay=weight_decay)
        if plain:
            return ref.sparse_row_update_runs_routed_ref(*tiers, *args, bits,
                                                         weight_decay=weight_decay)
        return _row_update.sparse_row_update_runs_routed(*tiers, *args, bits,
                                                         weight_decay=weight_decay)
    if isinstance(codes, CodeStore) and codes.packed:
        if plain:
            return ref.sparse_row_update_runs_packed_ref(
                codes.data, step, mu, nu, uniq, *args, codes.bits, codes.d,
                weight_decay=weight_decay)
        return _row_update.sparse_row_update_runs_packed(
            codes.data, step, mu, nu, uniq, *args, codes.bits, codes.d,
            weight_decay=weight_decay)
    if isinstance(codes, CodeStore):
        codes = codes.data
    if plain:
        return ref.sparse_row_update_runs_ref(codes, step, mu, nu, uniq, *args, bits,
                                              weight_decay=weight_decay)
    return _row_update.sparse_row_update_runs(codes, step, mu, nu, uniq, *args, bits,
                                              weight_decay=weight_decay)


def adam_update(params, grads, mu, nu, lr: float, bc1: float, bc2: float, *,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0, use_kernel: bool = True, inplace: bool = False):
    """One AdamW step over lists of tensors -> ``(new_params, new_mu, new_nu)``
    (the dense optimizer; one launch for the whole list on the card);
    ``inplace`` overwrites and returns ``params``, ``mu`` and ``nu``."""
    if not params or _plain(params[0], use_kernel, "adam_update",
                            (sum(p.numel() for p in params),)):
        return ref.adam_update_ref(params, grads, mu, nu, lr, bc1, bc2, b1=b1, b2=b2, eps=eps,
                                   weight_decay=weight_decay, inplace=inplace)
    return _adam.adam_update(params, grads, mu, nu, lr, bc1, bc2, b1=b1, b2=b2, eps=eps,
                             weight_decay=weight_decay, inplace=inplace)
