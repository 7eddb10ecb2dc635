"""CUDA ``dequant_gather`` / ``dequant_gather_packed``: fused row gather + dequantize.

Port of ``repro/kernels/dequant_gather.py:42`` and ``:78``; the kernels are
in ``csrc/dequant_gather.cu``, whose header says what bounds them and how
they are built for that.  Only the rows the ids select leave the integer
table: the fp32 table never exists.  Both are bitwise equal to the plain
versions in :mod:`repro_torch.kernels.ref`.

A gather at a serving wave takes a few microseconds on the card, less than
its Python wrapper, so the path to the launch is kept short (see
:mod:`repro_torch.kernels._build`).

:func:`dequant_gather_routed` and :func:`dequant_gather_packed_routed` read
a table behind a hot-row cache (:mod:`repro_torch.storage`): a lookup's
code row comes from the hot tier when its slot is ``>= 0``, else from the
backing, and is scaled by ``step[id]`` as above.  They are the gathers
above with the row's address routed (the same source, another template
instantiation), bitwise equal to ``ref.dequant_gather_routed_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.codestore import is_packable, packed_width
from repro_torch.kernels import _build

#: The kernel indexes its lane tasks (b rows of ceil(d/4) lanes) in 32 bits.
MAX_TASKS = 2 ** 31 - 1


def _check(kernel: str, name: str, table: torch.Tensor, dtype, width: int,
           step: torch.Tensor, ids: torch.Tensor, d: int) -> int:
    """Check every operand of a gather over ``table`` [n, width]; returns b."""
    if table.ndim != 2:
        raise ValueError(f"{kernel}: {name} must be 2-D, got {tuple(table.shape)}")
    n = table.shape[0]
    _build.check_operand(kernel, "step", step, torch.float32, (n,))
    if ids.ndim != 1:
        raise ValueError(f"{kernel}: ids must be 1-D, got shape {tuple(ids.shape)}")
    _build.check_operand(kernel, "ids", ids, torch.int32, ids.shape, step.device)
    _build.check_operand(kernel, name, table, dtype, (n, width), step.device)
    b = ids.shape[0]
    if b * (-(-d // 4)) > MAX_TASKS:
        raise ValueError(f"{kernel}: {b} ids x {d} columns exceed the kernel's 32-bit "
                         f"index of {MAX_TASKS} lane tasks")
    return b


def dequant_gather(codes: torch.Tensor, step: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """f32 [b, d] rows ``codes[ids] * step[ids]`` from int8 ``codes`` [n, d],
    f32 ``step`` [n] and int32 ``ids`` [b] on one CUDA device."""
    d = codes.shape[-1] if codes.ndim == 2 else 0
    b = _check("dequant_gather", "codes", codes, torch.int8, d, step, ids, d)
    dev = step.device
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b and d:
        with _build.on_device(dev):
            _build.launch(
                "dequant_gather", "dequant_gather", "dequant_gather_launch",
                codes.data_ptr(), step.data_ptr(), ids.data_ptr(), out.data_ptr(),
                codes.shape[0], d, b, _build.stream_of(dev),
            )
    return out


def dequant_gather_packed(packed: torch.Tensor, step: torch.Tensor, ids: torch.Tensor,
                          *, bits: int, d: int) -> torch.Tensor:
    """The same gather over packed uint8 rows [n, ceil(d*bits/8)], bits 2 or 4;
    the codes are unpacked and sign-extended in registers."""
    if not is_packable(bits):
        raise ValueError(f"dequant_gather_packed: bits must be 2 or 4, got {bits}")
    b = _check("dequant_gather_packed", "packed", packed, torch.uint8, packed_width(d, bits),
               step, ids, d)
    dev = step.device
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b and d:
        with _build.on_device(dev):
            _build.launch(
                "dequant_gather_packed", "dequant_gather", "dequant_gather_packed_launch",
                packed.data_ptr(), step.data_ptr(), ids.data_ptr(), out.data_ptr(),
                packed.shape[0], d, b, bits, _build.stream_of(dev),
            )
    return out


def _routed(kernel: str, backing: torch.Tensor, hot: torch.Tensor, slots: torch.Tensor,
            step: torch.Tensor, ids: torch.Tensor, *, bits: int, d: int,
            staged: bool) -> torch.Tensor:
    container = torch.int8 if bits == 8 else torch.uint8
    width = d if bits == 8 else packed_width(d, bits)
    if step.ndim != 1 or ids.ndim != 1 or hot.ndim != 2:
        raise ValueError(f"{kernel}: step and ids must be 1-D and hot 2-D, got "
                         f"{tuple(step.shape)}, {tuple(ids.shape)} and {tuple(hot.shape)}")
    n, b = step.shape[0], ids.shape[0]
    _build.check_operand(kernel, "step", step, torch.float32, (n,))
    dev = step.device
    _build.check_operand(kernel, "ids", ids, torch.int32, (b,), dev)
    rows = backing.shape[0] if staged and backing.ndim == 2 else n
    _build.check_operand(kernel, "backing", backing, container, (rows, width), dev)
    _build.check_operand(kernel, "hot", hot, container, (hot.shape[0], width), dev)
    _build.check_operand(kernel, "slots", slots, torch.int32, (b if staged else n,), dev)
    if b * (-(-d // 4)) > MAX_TASKS:
        raise ValueError(f"{kernel}: {b} ids x {d} columns exceed the kernel's 32-bit "
                         f"index of {MAX_TASKS} lane tasks")
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b and d:
        with _build.on_device(dev):
            _build.launch(
                kernel, "dequant_gather", "dequant_gather_routed_launch",
                backing.data_ptr(), hot.data_ptr(), slots.data_ptr(), step.data_ptr(),
                ids.data_ptr(), out.data_ptr(), n, d, b, bits, int(staged),
                _build.stream_of(dev),
            )
    return out


def dequant_gather_routed(backing: torch.Tensor, hot: torch.Tensor, slots: torch.Tensor,
                          step: torch.Tensor, ids: torch.Tensor, *,
                          staged: bool = False) -> torch.Tensor:
    """f32 [b, d] rows ``f32(row) * step[ids]`` of int8 codes behind a hot tier
    ``hot`` [cap, d].  Through the map (``staged=False``): ``backing`` [n, d]
    and ``slots`` = ``slot_of_id`` int32 [n], row = ``hot[slot]`` when
    ``slot = slots[id] >= 0`` else ``backing[id]``.  Staged: ``backing`` is
    the staged rows [k, d] and ``slots`` int32 [b] one per lookup, row =
    ``hot[slots[i]]`` when ``slots[i] >= 0``, else ``backing[-1 - slots[i]]``.
    Every slot must be below ``cap`` and every staged index below ``k`` (the
    storage tiers keep it so; the kernel does not check)."""
    d = hot.shape[-1] if hot.ndim == 2 else 0
    return _routed("dequant_gather_routed", backing, hot, slots, step, ids, bits=8, d=d,
                   staged=staged)


def dequant_gather_packed_routed(backing: torch.Tensor, hot: torch.Tensor, slots: torch.Tensor,
                                 step: torch.Tensor, ids: torch.Tensor, *, bits: int, d: int,
                                 staged: bool = False) -> torch.Tensor:
    """:func:`dequant_gather_routed` over packed uint8 rows, bits 2 or 4."""
    if not is_packable(bits):
        raise ValueError(f"dequant_gather_packed_routed: bits must be 2 or 4, got {bits}")
    return _routed("dequant_gather_packed_routed", backing, hot, slots, step, ids, bits=bits,
                   d=d, staged=staged)
