"""Exact and SR-compressed gradient all-reduces on ``torch.distributed`` (port
of repro/dist/collectives.py).

``compressed_psum_local`` is an integer all-reduce for gradients: every rank
SR-quantizes its local gradient against a *shared* step size (an
``all_reduce(MAX)`` of the ranks' absmax, so codes are comparable across
ranks), the codes are summed in int32 and the sum is de-quantized once.
Stochastic rounding keeps the reduction unbiased, E[Q_sr(g)] = g, so the
compression noise averages out across ranks (the paper's quantizer applied
to communication).  At 2 and 4 bits the codes travel packed
(``codestore.pack_codes``, ``8 // bits`` a byte): they are all-gathered and
each rank sums the unpacked stack; the other widths ``all_reduce(SUM)`` the
int32 codes.  Integer addition is associative, so both give the same sum.

``exact_pmean_local`` is the uncompressed fp32 mean with a fixed order:
every rank all-gathers the ranks' gradients and sums them in rank order,
the reduction :func:`exact_pmean_stacked` performs on a stack in one
process.  An ``all_reduce(SUM)`` would leave the order to the backend's
schedule.

Each ``*_local`` function runs in every rank of ``group`` (the default
group when None) on that rank's own tensor; its ``*_stacked`` twin computes
the same result in one process from the ranks' tensors stacked in rank
order.  The twins match the collectives operation for operation, so a
microbatched single-process trainer equals the n-rank trainer bit for bit.
The reference's jitted arithmetic is kept: XLA:CPU divides by a constant
as a multiply by its float32 reciprocal (``absmax / p``, ``total / n``,
the mean), and ``jnp.mean`` over the rank axis adds the ranks in order from
+0.0.

Every function that rounds stochastically takes its uniform noise as an
operand (a rank's noise is keyed by its rank: the caller draws it, see
``training/data_parallel.py``).  With ``use_kernels`` a CUDA gradient is
quantized through the ``sr_round`` kernel over its 2-D view, the shared
step expanded to the view's rows; a CPU gradient takes the kernel's plain
version.  Unlike the reference, which sends leaves of fewer rows than a
TPU sublane to jnp, the kernel takes every shape, so no leaf falls back.

Gloo takes CUDA tensors for every collective used here (all_gather of
float32 and uint8, all_reduce MAX of float32 and SUM of int32), so the same
calls serve NCCL groups on the card, gloo groups on the CPU and gloo groups
of CUDA tensors (several ranks on one card, where NCCL refuses).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import codestore, quant
from repro_torch.kernels import ops

f32 = torch.float32


def _recip(n: int) -> float:
    """float32 ``1 / n``: what XLA:CPU multiplies by where the reference
    divides by the constant ``n``."""
    return float(np.float32(1.0) / np.float32(n))


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    """A gradient leaf as the [rows, lanes] view the SR kernel takes (1-D and
    scalar leaves become one row)."""
    if x.ndim >= 2:
        return x.reshape(-1, x.shape[-1])
    return x.reshape(1, -1)


def _shared_step(absmax: torch.Tensor, bits: int) -> torch.Tensor:
    """The shared step ``max(absmax / p, 1e-30)`` of a ``bits``-bit sync."""
    _, p = quant.code_bounds(bits)
    return torch.clamp_min(absmax * _recip(p), 1e-30)


def _sr_codes(grad: torch.Tensor, step: torch.Tensor, noise: torch.Tensor, bits: int,
              use_kernels: bool) -> torch.Tensor:
    """int8 codes of ``grad`` SR-quantized against the scalar ``step`` with
    ``noise`` (shaped as ``grad``): ``quant.quantize_codes``, or with
    ``use_kernels`` ``ops.sr_round`` (bitwise the same)."""
    if not use_kernels:
        return quant.quantize_codes(grad, step, bits, "sr", noise)
    g2 = _as_2d(grad.to(f32)).contiguous()
    step_rows = step.reshape(1).expand(g2.shape[0]).contiguous()
    codes = ops.sr_round(g2, step_rows, _as_2d(noise.to(f32)).contiguous(), bits)
    return codes.reshape(grad.shape)


def _gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t``, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


#: Elements of a leaf that :func:`exact_pmean_local` all-gathers at a time:
#: a mean then holds the ranks' chunks beside the leaf, not n copies of it
#: (deepseek-moe-16b's expert stack, 738 MB a rank, on four ranks of one card).
MEAN_CHUNK = 1 << 24


def exact_pmean_local(grad: torch.Tensor, group=None) -> torch.Tensor:
    """fp32 mean of ``grad`` over the ranks of ``group``, summed in rank
    order: bitwise :func:`exact_pmean_stacked` of the ranks' stack (a leaf
    of more than :data:`MEAN_CHUNK` elements chunk by chunk, the same
    elementwise sums)."""
    grad = grad.to(f32)
    if grad.numel() <= MEAN_CHUNK:
        return exact_pmean_stacked(_gather(grad, group))
    flat = grad.reshape(-1)
    out = torch.empty_like(flat)
    for c0 in range(0, flat.numel(), MEAN_CHUNK):
        out[c0:c0 + MEAN_CHUNK] = exact_pmean_stacked(_gather(flat[c0:c0 + MEAN_CHUNK], group))
    return out.reshape(grad.shape)


def compressed_psum_local(grad: torch.Tensor, noise: torch.Tensor, bits: int = 8, group=None,
                          use_kernels: bool = False) -> torch.Tensor:
    """SR-quantized sum of ``grad`` over the ranks of ``group`` (float32).

    ``noise`` is this rank's uniform draw, shaped as ``grad``.  Per-element
    error is bounded by ``n_ranks * step`` with ``step = max|grad| / (2^{bits-1}
    - 1)`` over every rank, and is mean-zero when the ranks' noise differs.
    """
    absmax = torch.max(torch.abs(grad.to(f32))).reshape(1)
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    step = _shared_step(absmax[0], bits)
    codes = _sr_codes(grad, step, noise, bits, use_kernels)
    if codestore.is_packable(bits):
        total = _packed_psum_codes(codes, bits, group)
    else:
        total = codes.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(f32) * step


def _packed_psum_codes(codes: torch.Tensor, bits: int, group) -> torch.Tensor:
    """Sum sub-byte codes over ``group`` shipping the packed wire format: each
    rank packs its codes ``8 // bits`` a byte, the uint8 payload is
    all-gathered (the bytes ``sync_wire_bytes`` charges), and every rank
    unpacks and sums the stack in int32, in rank order."""
    wire = codestore.pack_codes(codes.reshape(1, -1), bits)
    total = torch.zeros(codes.numel(), dtype=torch.int32, device=codes.device)
    for part in _gather(wire, group):
        total += codestore.unpack_codes(part, bits, codes.numel()).reshape(-1).to(torch.int32)
    return total.reshape(codes.shape)


def compressed_pmean_local(grad: torch.Tensor, noise: torch.Tensor, bits: int = 8, group=None,
                           use_kernels: bool = False) -> torch.Tensor:
    """Mean-reducing :func:`compressed_psum_local`."""
    total = compressed_psum_local(grad, noise, bits, group, use_kernels)
    return total * _recip(dist.get_world_size(group))


# ---------------------------------------------------------------------------
# One-process twins over the ranks' tensors stacked in rank order (a tensor
# [n, ...] or a sequence of n tensors).
# ---------------------------------------------------------------------------


def exact_pmean_stacked(grad_stack: torch.Tensor | Sequence[torch.Tensor]) -> torch.Tensor:
    """The rank-order fp32 mean: ``((0 + g_0) + g_1) + ...`` times ``1/n``."""
    total = torch.zeros_like(grad_stack[0], dtype=f32)
    for g in grad_stack:
        total = total + g.to(f32)
    return total * _recip(len(grad_stack))


def compressed_psum_stacked(grad_stack: torch.Tensor | Sequence[torch.Tensor],
                            noise: torch.Tensor | Sequence[torch.Tensor], bits: int = 8,
                            use_kernels: bool = False) -> torch.Tensor:
    """One-process twin of :func:`compressed_psum_local`: ``noise[r]`` is rank
    ``r``'s draw; the absmax is the max over the stack (a max is exact in any
    order) and the int32 code sum is order-independent."""
    absmax = torch.stack([torch.max(torch.abs(g.to(f32))) for g in grad_stack]).max()
    step = _shared_step(absmax, bits)
    total = torch.zeros(grad_stack[0].shape, dtype=torch.int32, device=grad_stack[0].device)
    for g, u in zip(grad_stack, noise, strict=True):
        total += _sr_codes(g, step, u, bits, use_kernels).to(torch.int32)
    return total.to(f32) * step


def compressed_pmean_stacked(grad_stack: torch.Tensor | Sequence[torch.Tensor],
                             noise: torch.Tensor | Sequence[torch.Tensor], bits: int = 8,
                             use_kernels: bool = False) -> torch.Tensor:
    """One-process twin of :func:`compressed_pmean_local`."""
    total = compressed_psum_stacked(grad_stack, noise, bits, use_kernels)
    return total * _recip(len(grad_stack))


# ---------------------------------------------------------------------------
# Wire-byte accounting.
# ---------------------------------------------------------------------------


def sync_wire_bytes(grads, bits: int) -> int:
    """Per-rank gradient payload (bytes) one sync puts on the wire.

    ``grads`` is a sequence of tensors or shapes.  The fp32 baseline ships 4
    bytes per element; the compressed path ships the codes in their wire
    format (packed at ``8 // bits`` codes a byte at bits in {2, 4}, one
    byte a code otherwise) plus one fp32 absmax per tensor for the shared
    step.  Ring-schedule factors multiply both paths alike and are left out.
    """
    if not 2 <= bits <= 8 and bits != 32:
        raise ValueError(f"sync_bits must be 32 or in [2, 8], got {bits}")
    total = 0
    for leaf in grads:
        size = 1
        for dim in getattr(leaf, "shape", leaf):
            size *= int(dim)
        if bits == 32:
            total += size * 4
        elif codestore.is_packable(bits):
            total += -(-size // codestore.codes_per_byte(bits)) + 4
        else:
            total += size + 4
    return total


def sync_compression_ratio(grads, bits: int) -> float:
    """fp32 wire bytes / compressed wire bytes for one gradient sync."""
    return sync_wire_bytes(grads, 32) / max(sync_wire_bytes(grads, bits), 1)
