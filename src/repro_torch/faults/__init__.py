"""Deterministic fault injection and the recovery it proves out (port of
repro/faults).

The production claim needs more than happy-path parity: host tiers stall,
staged bytes flip, gradients blow up, jobs are preempted.  This package
makes those failures reproducible, so the recovery paths are tested:

* :mod:`repro_torch.faults.plan`: a seeded :class:`FaultPlan` whose named
  sites fire on scheduled steps / waves with per-site parameters; one plan,
  installed process-wide, drives every seam, and its JSON replays it (the
  reference's JSON: a plan written by either package loads in the other);
* :mod:`repro_torch.faults.recovery`: bounded retry with deterministic
  exponential backoff (:func:`retry_with_backoff`) and the typed counters
  (:class:`RetryStats`) every retried seam reports through;
* :mod:`repro_torch.faults.guards`: the trainers' non-finite guard, which
  skips a poisoned update (the state rolls back; the step counter and the
  generator advance), with :class:`GuardStats`.

Seam catalog (the sites a :class:`FaultPlan` can schedule), as the
reference's:

=========================  =================================================
site                       seam / recovery
=========================  =================================================
``trainer.nonfinite``      poisons the first dense-param leaf at step entry
                           (NaN forward -> NaN update); recovered by the
                           guard's skip-step (both trainers, ``guard=True``).
``alpt.delta``             scales the LPT/ALPT tables' Delta by ``scale``
                           (default inf) at step entry; a non-finite blowup
                           is recovered by the guard's skip-step, a finite
                           one bounded by ``ALPTConfig.step_clamp``.
``codestore.corrupt``      flips one byte of the cold tier's staged rows;
                           caught by their crc32 against the host copy and
                           fetched again on demand (counted, bitwise-equal).
``cold.fetch``             the cold tier's host gather raises
                           ``TransientFault`` (``fails`` times per fired
                           wave) or stalls ``stall_s``; recovered by bounded
                           retry + backoff.
``cold.prefetch_loss``     drops the staged prefetch; recovered by the
                           demand fetch (counted, bitwise-equal).
``cache.admission``        the hot-row cache refuses a wave's admissions
                           (OOM); the wave runs off the backing tier
                           (``admission_oom``, ``served_degraded`` tick).
``tiered.writeback``       the dirty write-back of ``HotRowCache.flush``
                           raises ``TransientFault`` (``fails`` times per
                           fired flush); recovered by bounded retry +
                           backoff, the rows left flagged on exhaustion.
``checkpoint.corrupt``     :func:`corrupt_checkpoint_leaf` flips a byte of a
                           committed leaf; the checkpoint manager's
                           checksums refuse it and fall back to the last
                           good step.
``kernels.force_fallback`` sends every dispatch of the ops in ``ops`` (all
                           when absent) to the plain version while the plan
                           is installed (reason ``fault-injected``, counted;
                           bitwise-equal by the kernels' contract).
``train.preempt``          requests a graceful shutdown after the scheduled
                           step (checkpoint, exit 75); recovered by the
                           exact resume.
=========================  =================================================
"""
from repro_torch.faults.guards import GuardStats, wrap_ctr_step, wrap_lm_step
from repro_torch.faults.plan import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    TransientFault,
    active_plan,
    corrupt_checkpoint_leaf,
    fires,
    install,
    lookup,
    step_mask,
    uninstall,
)
from repro_torch.faults.recovery import RetryError, RetryStats, retry_with_backoff

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "GuardStats",
    "InjectedFault",
    "RetryError",
    "RetryStats",
    "TransientFault",
    "active_plan",
    "corrupt_checkpoint_leaf",
    "fires",
    "install",
    "lookup",
    "retry_with_backoff",
    "step_mask",
    "uninstall",
    "wrap_ctr_step",
    "wrap_lm_step",
]
