"""Mixed per-field precision: one LPT sub-table per bit-width group (port of
repro/methods/mixed.py).

CTR tables concatenate per-field vocabularies, and fields are asymmetric: a
few small fields hit on almost every example, a few huge ones that hold the
memory.  This method gives each field a bit width, from ``spec.field_bits``
or from the field's mean per-row hit rate (:func:`assign_field_bits`), and
composes the table from one LPT sub-table per distinct width; the sub-byte
groups are packed.

Geometry: fields occupy contiguous global id ranges (``field_offsets``).
Group ``g`` stacks the rows of every field assigned to it; global id ``i``
of field ``f`` lives at row ``i - offsets[f] + field_local[f]`` of
sub-table ``field_group[f]``.  Without ``field_cards`` the plan is a single
group at ``spec.bits`` (ordinary LPT semantics).

The lookup is a masked sum over the groups in group order, the same
composition ``serving.table.MixedQuantTable.rows`` uses, so training reads
and Engine reads agree bit for bit.  Each group's row step sees the whole
wave, with the other groups' lookups mapped to the group's sentinel (its
scratch row on a padded table, past the table otherwise).  SR draws: one
[K, d] per group in group order (the reference's ``fold_in(nk, g)``); the
dense (LM) step's one per group at its allocated shape.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import lpt as lpt_core
from repro_torch.core import quant
from repro_torch.dist.sharding import P
from repro_torch.methods.base import TILE, IntegerTableMethod, _round_up, pad_grads, register
from repro_torch.serving import table as serving_tbl
from repro_torch.storage.base import CacheSlot


class MixedTable(NamedTuple):
    """One LPT sub-table per bit-width group (the field maps live in the spec)."""

    subs: tuple[lpt_core.LPTTable, ...]


def assign_field_bits(cards: tuple[int, ...], *, hot_rate: float = 1.0 / 64.0,
                      cold_rate: float = 1.0 / 4096.0) -> tuple[int, ...]:
    """Bit width per field from the synthetic stream's row-hit statistics:
    every example looks up one id per field, so a field of cardinality c
    hits each row at mean rate 1/c.  Hot fields keep 8 bits, mid fields 4,
    huge vocabularies 2."""
    out = []
    for c in cards:
        rate = 1.0 / max(int(c), 1)
        out.append(8 if rate >= hot_rate else (4 if rate >= cold_rate else 2))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MixedPlan:
    """Static field -> (group, local row) layout derived from one spec."""

    field_offsets: tuple[int, ...]  # [F] global start row per field
    field_bits: tuple[int, ...]  # [F] resolved bit width per field
    field_group: tuple[int, ...]  # [F] sub-table index per field
    field_local: tuple[int, ...]  # [F] local start row inside the sub
    group_bits: tuple[int, ...]  # [G] bit width per sub-table
    group_rows: tuple[int, ...]  # [G] live rows per sub-table
    group_fields: tuple[tuple[int, ...], ...]  # [G] field ids per sub-table


def plan_of(spec) -> MixedPlan:
    """Resolve ``spec.field_cards`` / ``field_bits`` into a static layout."""
    cards = spec.field_cards if spec.field_cards is not None else (spec.n,)
    if sum(cards) != spec.n:
        raise ValueError(f"field_cards sum {sum(cards)} != table rows {spec.n}")
    if spec.field_bits is not None:
        fbits = tuple(int(b) for b in spec.field_bits)
        if len(fbits) != len(cards):
            raise ValueError(f"{len(fbits)} field_bits for {len(cards)} fields")
    elif spec.field_cards is None:
        fbits = (spec.bits,)
    else:
        fbits = assign_field_bits(cards)
    for b in fbits:
        if not 2 <= b <= 8:
            raise ValueError(f"field bit width {b} outside [2, 8]")
    group_bits = tuple(sorted(set(fbits), reverse=True))
    field_group = tuple(group_bits.index(b) for b in fbits)
    offsets, acc = [], 0
    for c in cards:
        offsets.append(acc)
        acc += int(c)
    local_acc = [0] * len(group_bits)
    field_local = []
    for f, c in enumerate(cards):
        g = field_group[f]
        field_local.append(local_acc[g])
        local_acc[g] += int(c)
    return MixedPlan(
        field_offsets=tuple(offsets), field_bits=fbits, field_group=field_group,
        field_local=tuple(field_local), group_bits=group_bits, group_rows=tuple(local_acc),
        group_fields=tuple(tuple(f for f in range(len(cards)) if field_group[f] == g)
                           for g in range(len(group_bits))),
    )


def _map_ids(plan: MixedPlan, ids: torch.Tensor):
    return serving_tbl.map_field_ids(plan.field_offsets, plan.field_group, plan.field_local,
                                     ids)


@register("mixed")
class MixedMethod(IntegerTableMethod):
    def noise_draws(self, spec):
        return len(plan_of(spec).group_bits)

    def table_pspec(self, row, col, *, row_optimizer="adam"):
        # Group row counts rarely divide the mesh axes; stay replicated (the
        # degenerate single-group layout, the only one a spec without
        # field_cards makes).
        sub = lpt_core.LPTTable(codes=P(), step=P(), mu=P(), nu=P(), count=P())
        return MixedTable(subs=(sub,))

    def sparse_noise(self, noise):
        return list(noise)

    def init(self, generator, spec):
        plan = plan_of(spec)
        return MixedTable(subs=tuple(
            lpt_core.init_table(
                generator,
                _round_up(plan.group_rows[g] + 1, TILE) if spec.pad_to_tiles
                else plan.group_rows[g],
                spec.d_padded, bits_g, init_scale=spec.init_scale, clip_value=spec.clip_value,
                optimizer=spec.row_optimizer, use_kernels=spec.use_kernels, packed=spec.packed)
            for g, bits_g in enumerate(plan.group_bits)))

    def lookup(self, state, ids, spec, grad_scale=1.0):
        gid, local = _map_ids(plan_of(spec), ids)
        reads = [functools.partial(lpt_core.lookup, sub, use_kernels=spec.use_kernels,
                                   out_dim=spec.d) for sub in state.subs]
        return serving_tbl.masked_sum(gid, local, spec.d, reads)

    def dense_table(self, state, spec):
        return self.lookup(state, torch.arange(spec.n, dtype=torch.int32,
                                               device=state.subs[0].step.device), spec)

    def checkpoint_schema(self, spec):
        plan = plan_of(spec)
        out = {}
        for g, bits_g in enumerate(plan.group_bits):
            rows = plan.group_rows[g]
            out.update(lpt_core.schema(_round_up(rows + 1, TILE) if spec.pad_to_tiles else rows,
                                       spec.d_padded, bits_g, optimizer=spec.row_optimizer,
                                       packed=spec.packed, prefix=f".subs[{g}]"))
        return out

    def memory_bytes(self, state, spec, *, training=True, stored=False):
        # Container-actual per group (packed sub-byte groups really hold
        # ceil(d * bits / 8) bytes per row) + the per-row Delta (+ the
        # row-optimizer slots).
        return sum(lpt_core.memory_bytes(sub, sub.codes.bits, count_optimizer=stored and training)
                   for sub in state.subs)

    def sparse_apply(self, state, ids, g_rows, *, spec, lr, weight_decay, noise):
        plan = plan_of(spec)
        gid, local = _map_ids(plan, ids)
        subs = []
        for g, sub in enumerate(state.subs):
            rows_g = plan.group_rows[g]
            # Non-members map to the dedup sentinel: one slot whose run lands
            # on the scratch row (padded tables) or past the table, never on
            # a live row.
            sub_ids = torch.where(gid == g, local, rows_g)
            subs.append(lpt_core.sparse_apply(
                sub, sub_ids, g_rows, lr=lr, bits=plan.group_bits[g],
                rounding=spec.alpt.rounding, noise=noise[g], optimizer=spec.row_optimizer,
                weight_decay=weight_decay, id_space=rows_g, use_kernels=spec.use_kernels))
        return MixedTable(subs=tuple(subs))

    def dense_noise(self, generator, state, spec):
        return [quant.sr_noise(generator, tuple(sub.codes.shape)) for sub in state.subs]

    def storage_spec(self, spec):
        """One slot per bit-width group; global ids reach a group's rows
        through the lookups' field maps (other groups' ids -> -1, which the
        cache policy ignores)."""
        plan = plan_of(spec)
        return serving_tbl.group_slots(
            plan.field_offsets, plan.field_group, plan.field_local, plan.group_rows,
            get=lambda s, g: s.subs[g],
            put=lambda s, g, t: MixedTable(subs=s.subs[:g] + (t,) + s.subs[g + 1:]))

    def dense_update(self, state, opt, grads, *, spec, lr, weight_decay, noise=None,
                     delta_grad=None, batch_rows=None):
        plan = plan_of(spec)
        cards = spec.field_cards if spec.field_cards is not None else (spec.n,)
        subs = []
        for g, sub in enumerate(state.subs):
            # Re-lay the global [n, d] gradient in this group's row order.
            gg = torch.cat([grads[plan.field_offsets[f]: plan.field_offsets[f] + cards[f]]
                            for f in plan.group_fields[g]], 0)
            subs.append(lpt_core.dense_apply(
                sub, pad_grads(gg, sub), lr=lr, bits=plan.group_bits[g], rounding=spec.alpt.rounding,
                noise=None if noise is None else noise[g], optimizer=spec.row_optimizer,
                weight_decay=weight_decay, use_kernels=spec.use_kernels))
        return MixedTable(subs=tuple(subs)), None, {}

    def serving_state(self, state, spec):
        """Integer-resident export: every group's (packed) codes and per-row
        Delta, plus the static field maps the Engine routes ids with."""
        plan = plan_of(spec)
        return serving_tbl.MixedQuantTable(
            subs=tuple(serving_tbl.QuantTable(codes=sub.codes, step=sub.step,
                                              n=plan.group_rows[g], d=spec.d,
                                              use_kernels=spec.use_kernels)
                       for g, sub in enumerate(state.subs)),
            field_offsets=plan.field_offsets, field_group=plan.field_group,
            field_local=plan.field_local, n=spec.n, d=spec.d)
