"""Ambient distribution context (port of repro/dist/context.py).

Models never mention mesh axes.  The reference's call ``hint(x, kind)``
with a *logical* kind (``q_heads``, ``carry``, ``logits``, ...), and the
active ``(mesh, policy)`` context installed by ``use(mesh, policy)``
decides the physical spec (:func:`_spec_for`).  With no active context
``hint`` is the identity and nothing runs across ranks, so the same model
code runs in one process.

Kinds and their layouts:

  q_heads     [B, T, H, hd]   heads over 'model', batch over data axes
  kv_heads    [B, T, KV, hd]  (same, KV may be smaller than H under GQA)
  carry       [B, T, d]       scan carry; T over 'model' iff seq-parallel
  activation  [B, T, d]       block input / output
  head_weight [V, d]          vocab over 'model' (fallback: d over 'model')
  embed_table [V, d]          de-quantized LPT/ALPT table + its gradient
  logits      [B, C, V]       vocab over 'model', batch over data axes
  moe_buf     [B, E, C, d]    experts over 'model'

Every placement is divisibility-guarded by the spec builders' own guard
(``sharding._dp_or_none`` / ``sharding.model_or_none``), so a hint and a
state spec never disagree about what fits an axis.

The port holds explicit per-rank shards, so a tensor already has its
layout and :func:`hint` changes nothing: the collectives the reference's
hints imply run at the same sites through :mod:`repro_torch.dist.tensor_parallel`,
which reads this context (:func:`spec_of`).  :func:`hint` is kept for
parity with the reference's API (its tests hold it); no model code calls
it.  :func:`moe_ep_context` picks the explicit expert-parallel dispatch
(``models.moe.moe_forward_ep``) under an ``ep`` policy, as in the
reference's ``_moe_apply``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

from repro_torch.dist.sharding import P
from repro_torch.dist.sharding import _dp_or_none as _dp_entry
from repro_torch.dist.sharding import model_or_none as _model_entry


@dataclasses.dataclass(frozen=True)
class StepLayout:
    """What a sharded step knows of its operands (the port's, where GSPMD
    sees the whole arrays): the table is split over d (its vocabulary does
    not divide the model axis), the batch is split over the data axis."""

    width_split: bool = False
    batch_split: bool = False


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Any  # repro_torch.launch.mesh.HostMesh
    policy: Any  # repro_torch.dist.sharding.Policy
    layout: StepLayout = StepLayout()


_STACK: list[DistContext] = []


@contextlib.contextmanager
def use(mesh, policy, layout: StepLayout = StepLayout()):
    """Install ``(mesh, policy)`` as the ambient distribution context around
    the step's calls (the reference wraps its jit trace); the sharded step
    adds its ``layout``.  Contexts nest; the innermost wins."""
    _STACK.append(DistContext(mesh=mesh, policy=policy, layout=layout))
    try:
        yield _STACK[-1]
    finally:
        _STACK.pop()


def current() -> DistContext | None:
    return _STACK[-1] if _STACK else None


def moe_ep_context() -> DistContext | None:
    """The active context iff the policy asks for explicit expert-parallel
    dispatch (the reference's shard_map all-to-all)."""
    ctx = current()
    if ctx is None or not getattr(ctx.policy, "ep", False):
        return None
    return ctx


def _spec_for(kind: str, shape, pol, mesh) -> P | None:
    nd = len(shape)
    if kind in ("q_heads", "kv_heads"):
        if nd != 4:
            return None
        return P(_dp_entry(pol, shape[0], mesh), None, _model_entry(pol, shape[2], mesh), None)
    if kind in ("carry", "activation"):
        if nd != 3:
            return None
        seq = _model_entry(pol, shape[1], mesh) if pol.seq_parallel else None
        return P(_dp_entry(pol, shape[0], mesh), seq, None)
    if kind in ("head_weight", "embed_table"):
        if nd != 2:
            return None
        vocab = _model_entry(pol, shape[0], mesh)
        if vocab is not None:
            return P(vocab, None)
        return P(None, _model_entry(pol, shape[1], mesh))
    if kind == "logits":
        if nd < 2:
            return None
        mid = [None] * (nd - 2)
        return P(_dp_entry(pol, shape[0], mesh), *mid, _model_entry(pol, shape[-1], mesh))
    if kind == "moe_buf":
        if nd != 4:
            return None
        return P(_dp_entry(pol, shape[0], mesh), _model_entry(pol, shape[1], mesh), None, None)
    raise ValueError(f"unknown sharding hint kind {kind!r}")


def spec_of(kind: str, shape) -> P | None:
    """The active context's spec for a ``kind`` tensor of the whole
    ``shape``, or None without a context (or when no mesh axis fits)."""
    ctx = current()
    if ctx is None:
        return None
    spec = _spec_for(kind, tuple(shape), ctx.policy, ctx.mesh)
    if spec is None or all(e is None for e in spec):
        return None
    return spec


def hint(x, kind: str):
    """The reference's layout constraint: the identity here, since a shard
    has its layout already (the kind is still checked)."""
    ctx = current()
    if ctx is not None:
        _spec_for(kind, tuple(x.shape), ctx.policy, ctx.mesh)
    return x
