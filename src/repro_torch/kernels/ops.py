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
(``ops.py:178`` there: op name -> count); the packed gather has its own key
``dequant_gather_packed`` because it is its own kernel here.
"""
from __future__ import annotations

import torch

from repro_torch.core.codestore import CodeStore
from repro_torch.kernels import _build, ref
from repro_torch.kernels import dequant_gather as _gather
from repro_torch.kernels import sr_round as _sr_round


def kernel_calls() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_kernel_calls`, by kernel."""
    return dict(_build.LAUNCHES)


def reset_kernel_calls() -> None:
    _build.reset_launches()


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
