"""Trainer guardrails: the non-finite skip-step guard and the two trainer
seams (port of repro/faults/guards.py).

The guard wraps a train step.  After the step it checks, on the device, the
step's loss and every dense parameter for non-finite values; on a hit it
rolls the state back to its value before the step, and only the step
counter and the generator advance (the reference's skip-step semantics:
the poisoned batch is dropped, the data and noise streams stay where an
unguarded run has them).

The reference rolls back by ``lax.cond`` over an immutable state.  Here:

* the CTR step writes in place (the dense parameters' ``copy_``, the
  integer tables' row steps), so :func:`wrap_ctr_step` first copies what the
  step will write: the batch's rows of every table's codes (a cached
  table's backing rows and its whole hot tier), Delta and row-optimizer
  slots, plus the scratch rows the dedup sentinel lands on, and the dense
  parameters; a skip copies them back.  The dense Adam state, a float-leaf
  method's leaves and their Adam state come back new from the step, so the
  state before the step still holds the old ones;
* the LM step is functional (every tensor of its new state is new), so
  :func:`wrap_lm_step` keeps the state before the step and copies nothing.

The port keeps the optimizers' step counters (``OptState.step``,
``LPTTable.count``) on the host, where they become the kernels' bias
corrections, so an exact skip needs the verdict there: the guard reads its
device verdict once per step, after the step's launches.  The CTR step
waits for the card already (its batch upload and the row writes' range
check), and the training loops read each step's loss.

The same wrappers host the two trainer seams, which poison the step's
input and are undone by the rollback:

* ``trainer.nonfinite`` multiplies the first float leaf of the dense
  parameters (the reference's pytree order) by NaN;
* ``alpt.delta`` scales every LPT/ALPT table's Delta by ``scale`` (default
  inf); a finite scale that does not trip the guard stays in the new state,
  untouched rows included, and ALPT's ``step_clamp`` bounds it.

The seams bind to the plan installed when the step is wrapped (the trainer's
construction), as in the reference.  The step's metrics gain
``guard_skipped``, ``fault_nonfinite_fired`` and ``fault_delta_fired``;
:class:`GuardStats` adds them up, with ALPT's ``delta_clamped`` (a device
scalar), and materializes the totals only when read.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.faults import plan as _plan

#: Metric keys the guard adds to every wrapped step's output.
GUARD_METRIC_KEYS = ("guard_skipped", "fault_nonfinite_fired", "fault_delta_fired")


def lpt_tables(tree) -> list:
    """Every ``LPTTable`` inside a table state (an LPTTable, or NamedTuples
    and tuples of them: qr_*'s two sub-tables, mixed's groups), in order."""
    from repro_torch.core.lpt import LPTTable  # core.lpt reaches kernels.ops, which imports plan

    if isinstance(tree, LPTTable):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in lpt_tables(x)]
    return []


def _map_tables(tree, fn):
    """``tree`` with every ``LPTTable`` in it replaced by ``fn(table)``."""
    from repro_torch.core.lpt import LPTTable

    if isinstance(tree, LPTTable):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tables(x, fn) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tables(x, fn) for x in tree)
    return tree


def _all_finite(loss, params) -> torch.Tensor:
    """A 0-d bool tensor on the loss's device: the loss and every float
    tensor of ``params`` finite (checked over one concatenation: a handful
    of launches, not three a tensor)."""
    ok = torch.isfinite(torch.as_tensor(loss)).all()
    flat = [p.detach().reshape(-1) for p in params if p.is_floating_point()]
    if flat:
        ok = ok & torch.isfinite(torch.cat(flat)).all()
    return ok


class _Saved:
    """Rows ``rows`` (int64, on the tensor's device; None: all of it) of a
    tensor the step writes in place, copied before the step."""

    def __init__(self, t: torch.Tensor, rows: torch.Tensor | None):
        self.t, self.rows = t, rows
        self.saved = t.detach().clone() if rows is None else t.index_select(0, rows)

    def restore(self) -> None:
        with torch.no_grad():
            if self.rows is None:
                self.t.copy_(self.saved)
            else:
                self.t.index_copy_(0, self.rows, self.saved)

    @property
    def nbytes(self) -> int:
        return self.saved.numel() * self.saved.element_size()


class _SavedFlat(_Saved):
    """Tensors of one dtype the step writes whole (the dense parameters),
    copied before the step into one buffer (one launch)."""

    def __init__(self, tensors):
        self.tensors = list(tensors)
        self.saved = torch.cat([t.detach().reshape(-1) for t in self.tensors])

    def restore(self) -> None:
        with torch.no_grad():
            parts = self.saved.split([t.numel() for t in self.tensors])
            for t, part in zip(self.tensors, parts):
                t.copy_(part.view_as(t))


def _batch_rows(slot, table, flat_ids: np.ndarray) -> np.ndarray:
    """The rows of ``table`` a step over ``flat_ids`` can write: the ids'
    local rows in range, and the scratch rows past the slot's live ones
    (where the dedup sentinel's run lands on a padded table)."""
    n_rows = table.codes.shape[0]
    local = np.asarray(slot.local_ids(flat_ids), np.int64).reshape(-1)
    local = local[(local >= 0) & (local < n_rows)]
    return np.concatenate([local, np.arange(min(slot.rows, n_rows), n_rows)])


def ctr_snapshot(state, ids, slots, *, whole_delta: bool = False) -> list[_Saved]:
    """What a CTR step over ``ids`` writes in place: the dense parameters
    and, for each table of ``slots`` (the method's ``storage_spec``), the
    batch's rows of its codes (behind a cache: the backing's rows and the
    whole hot tier), Delta (``whole_delta``: all of it, for ``alpt.delta``)
    and row-optimizer slots."""
    from repro_torch.core.tiered import TieredCodes

    saved: list[_Saved] = [_SavedFlat(state.dense.parameters())]
    if not slots:
        return saved
    flat = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids).reshape(-1)
    tables = [slot.get(state.emb_state) for slot in slots]
    per_slot = [_batch_rows(slot, t, flat) for slot, t in zip(slots, tables)]
    device = tables[0].step.device
    # One upload for every slot's rows.
    rows = torch.split(torch.from_numpy(np.concatenate(per_slot)).to(device),
                       [r.size for r in per_slot])
    for t, r in zip(tables, rows):
        codes = t.codes
        if isinstance(codes, TieredCodes):
            saved += [_Saved(codes.backing.data, r), _Saved(codes.hot.data, None)]
        else:
            saved.append(_Saved(codes.data, r))
        saved.append(_Saved(t.step, None if whole_delta else r))
        saved += [_Saved(t.mu, r), _Saved(t.nu, r)]
    return saved


def _seams():
    """``(fire_nonfinite, fire_delta, delta_scale)`` of the installed plan."""
    nf_spec = _plan.lookup("trainer.nonfinite")
    dl_spec = _plan.lookup("alpt.delta")
    scale = float(dl_spec.param("scale", math.inf)) if dl_spec is not None else 1.0
    return _plan.step_mask(nf_spec), _plan.step_mask(dl_spec), scale


def _guard_metrics(m: dict, skipped: bool, nf: bool, dl: bool) -> dict:
    return {**m, **dict(zip(GUARD_METRIC_KEYS, (int(skipped), int(nf), int(dl))))}


def wrap_ctr_step(step_fn, *, method, spec):
    """Guard a CTR step ``(state, ids, labels, **kw) -> (state, metrics)``
    of ``repro_torch.training.ctr_trainer`` (same signature).  ``method`` /
    ``spec`` give the integer tables' slots (``method.storage_spec``) whose
    batch rows :func:`ctr_snapshot` holds."""
    from repro_torch.optim import tree_leaves

    fire_nf, fire_dl, scale = _seams()
    slots = method.storage_spec(spec) if method.is_integer_table else ()

    def guarded(state, ids, labels, **kw):
        nf, dl = fire_nf(state.step), fire_dl(state.step)
        saved = ctr_snapshot(state, ids, slots, whole_delta=dl)
        with torch.no_grad():
            if nf:
                tree_leaves(state.dense.param_tree())[0].mul_(math.nan)
            if dl:
                for t in lpt_tables(state.emb_state):
                    t.step.mul_(scale)
        new_state, m = step_fn(state, ids, labels, **kw)
        ok = _all_finite(m["loss"], new_state.dense.parameters())
        skipped = not bool(ok)  # the one host read (the optimizers' clocks are host ints)
        if skipped:
            for s in saved:
                s.restore()
            new_state = state._replace(step=new_state.step, generator=new_state.generator)
        return new_state, _guard_metrics(m, skipped, nf, dl)

    return guarded


def wrap_lm_step(step_fn, group=None):
    """Guard an LM step ``(state, batch, *args, **kw) -> (state, metrics)``
    of ``repro_torch.training.lm_trainer`` (same signature).  The step is
    functional, so the seams poison copies and a skip returns the state
    before the step with its step counter and generator advanced.

    ``group``: the step runs on one rank's shards of a mesh, and the
    verdict is the whole group's (any rank's loss or param shards
    non-finite, one all-reduce before the host read), as the reference's
    one program judges its global loss and params; every rank then keeps
    or rolls back together."""
    from repro_torch.optim import tree_leaves, tree_like

    fire_nf, fire_dl, scale = _seams()

    def guarded(state, batch, *args, **kw):
        nf, dl = fire_nf(state.step), fire_dl(state.step)
        st = state
        if nf:
            leaves = tree_leaves(st.params)
            first = next(i for i, x in enumerate(leaves) if x.is_floating_point())
            leaves = [*leaves[:first], leaves[first] * math.nan, *leaves[first + 1:]]
            st = st._replace(params=tree_like(st.params, leaves))
        if dl:
            st = st._replace(table=_map_tables(st.table,
                                               lambda t: t._replace(step=t.step * scale)))
        new_state, m = step_fn(st, batch, *args, **kw)
        ok = _all_finite(m["loss"], tree_leaves(new_state.params))
        if group is not None:
            bad = (~ok).to(torch.float32).reshape(1)
            dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
            ok = bad[0] == 0
        skipped = not bool(ok)  # the one host read (the optimizers' clocks are host ints)
        if skipped:
            new_state = state._replace(step=new_state.step, generator=new_state.generator)
        return new_state, _guard_metrics(m, skipped, nf, dl)

    return guarded


class GuardStats:
    """Totals of the guard and fault counters over the steps observed.

    ``observe(metrics)`` adds a step's values as they are (host ints, or
    device scalars such as ALPT's ``delta_clamped``) without waiting for the
    card; reading a property or :meth:`to_json` materializes the totals.
    """

    def __init__(self):
        self.steps = 0
        self._skipped = 0
        self._nonfinite_fired = 0
        self._delta_fired = 0
        self._delta_clamped = 0

    def observe(self, metrics) -> None:
        self.steps += 1
        self._skipped = self._skipped + metrics.get("guard_skipped", 0)
        self._nonfinite_fired = self._nonfinite_fired + metrics.get("fault_nonfinite_fired", 0)
        self._delta_fired = self._delta_fired + metrics.get("fault_delta_fired", 0)
        self._delta_clamped = self._delta_clamped + metrics.get("delta_clamped", 0)

    @property
    def skipped(self) -> int:
        return int(self._skipped)

    @property
    def nonfinite_fired(self) -> int:
        return int(self._nonfinite_fired)

    @property
    def delta_fired(self) -> int:
        return int(self._delta_fired)

    @property
    def delta_clamped(self) -> int:
        return int(self._delta_clamped)

    def publish(self) -> None:
        """Mirror the totals into the ``faults.guard.*`` registry gauges
        (gauges: the totals are cumulative already; called at report time,
        never per step)."""
        from repro_torch.obs import counters as obs_counters

        reg = obs_counters.registry()
        for name, val in self.to_json().items():
            reg.gauge(f"faults.guard.{name}").set(val)

    def to_json(self) -> dict:
        return {"steps": self.steps, "skipped": self.skipped,
                "nonfinite_fired": self.nonfinite_fired, "delta_fired": self.delta_fired,
                "delta_clamped": self.delta_clamped}
