"""The `EmbeddingMethod` protocol + registry (port of repro/methods/base.py).

Every consumer dispatches on ``spec.method`` through :func:`get`; every
method of the reference is ported.  A method bundles the serving surface
(``init`` / ``lookup`` / ``memory_bytes`` / ``serving_state``), the
float-leaf formulation (``trainable_params`` / ``with_params``: fp, lsq,
pact, hash, prune), the sparse row formulation of integer tables
(``sparse_apply`` / ``fused_row_step``, the CTR path: lpt, alpt, qr_lpt,
qr_alpt, mixed), the dense formulation (``dense_params`` /
``dense_table_from`` / ``dense_update`` / ``dense_delta_grad``, the LM path:
the gradient of the whole [n, d] table), and the host-side refresh hook
(``host_sync`` / ``host_refresh`` / ``refresh_every``: prune's mask),
and the tiered-storage hook ``storage_spec`` (the cacheable sub-tables).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import lpt as lpt_core
from repro_torch.core import quant
from repro_torch.core.alpt import ALPTConfig
from repro_torch.core.pruning import PruneConfig
from repro_torch.dist.sharding import P
from repro_torch.kernels import ref
from repro_torch.optim import adam_update, tree_leaves, tree_like
from repro_torch.serving import table as serving_tbl
from repro_torch.storage.base import CacheSlot

#: Row/width multiple of ``pad_to_tiles``: the reference's sublane multiple,
#: kept so a padded reference state loads into the port with its geometry.
TILE = 8


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def pad_grads(grads: torch.Tensor, table) -> torch.Tensor:
    """A dense gradient zero-padded to ``table``'s allocated [rows, width]
    (a ``pad_to_tiles`` table's scratch rows and columns are never looked
    up, so their gradient is exactly zero)."""
    n_alloc, d_alloc = table.codes.shape
    n, d = grads.shape
    if (n, d) == (n_alloc, d_alloc):
        return grads
    return torch.nn.functional.pad(grads, (0, d_alloc - d, 0, n_alloc - n))


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Declarative description of one embedding table (method + geometry)."""

    method: str  # any name in repro_torch.methods.available()
    n: int
    d: int
    bits: int = 8
    init_scale: float = 1e-2
    # LPT (Xu et al. 2021) fixes Delta via a tuned clip value:
    clip_value: float | None = None
    alpt: ALPTConfig = ALPTConfig()
    row_optimizer: str = "adam"
    # Route lookups and the init quantize through the CUDA kernels
    # (repro_torch.kernels.ops); False asks for the plain versions on any
    # device.  CPU tensors take the plain versions either way.
    use_kernels: bool = True
    # Allocate rows past the id space (scratch row, rounded to TILE) and
    # round the width up to TILE, as the reference does; lookups slice the
    # live (n, d) back out.
    pad_to_tiles: bool = False
    # Pack sub-byte codes (bits in {2, 4}) into uint8; False keeps a byte each.
    packed: bool = True
    hash_compression: float = 2.0  # hash / qr_*: (r + n/r) ~= n / compression
    prune: PruneConfig = PruneConfig()
    # mixed: cardinalities of the CTR fields the table spans (sum == n), and
    # optionally a bit width per field; None leaves one group at ``bits``.
    field_cards: tuple[int, ...] | None = None
    field_bits: tuple[int, ...] | None = None

    @property
    def is_integer_table(self) -> bool:
        return get(self.method).is_integer_table

    @property
    def n_padded(self) -> int:
        """Allocated rows: id space (+ scratch row, TILE-rounded) if padded."""
        return _round_up(self.n + 1, TILE) if self.pad_to_tiles else self.n

    @property
    def d_padded(self) -> int:
        """Allocated embedding width (TILE-rounded if padded)."""
        return _round_up(self.d, TILE) if self.pad_to_tiles else self.d


class EmbeddingMethod(abc.ABC):
    """One embedding method: state, lookup, serving export."""

    name: str = "?"  # set by @register
    #: Table is integer codes (no differentiable float leaves).
    is_integer_table: bool = False
    #: Learns its step size Delta through a second fake-quant forward (ALPT
    #: Algorithm 1 line 4): the dense trainer supplies a delta-grad closure.
    has_learned_step: bool = False
    #: Needs a host-side state refresh between steps (DeepLight's mask
    #: recomputation): the trainer wraps its step with ``host_refresh``.
    has_host_refresh: bool = False

    def noise_draws(self, spec: EmbeddingSpec) -> int:
        """SR noise tensors [K, d_alloc] one ``fused_row_step`` consumes."""
        return 0

    def capabilities(self) -> dict[str, bool]:
        """The capability flags a checkpoint manifest records."""
        return {
            "is_integer_table": self.is_integer_table,
            "has_learned_step": self.has_learned_step,
            "has_host_refresh": self.has_host_refresh,
        }

    @abc.abstractmethod
    def init(self, generator: torch.Generator, spec: EmbeddingSpec) -> Any:
        """Initialize the table state on ``generator.device``."""

    def checkpoint_schema(self, spec: EmbeddingSpec) -> dict:
        """Leaf path -> ``{shape, dtype}`` of the state :meth:`init` builds for
        ``spec`` (paths as a checkpoint spells them, a code container as its
        ``.data`` bytes, Python ints as int32), without building it: what a
        manifest records so that a restore refuses another geometry first."""
        raise NotImplementedError(f"{self.name!r} has no checkpoint schema")

    @abc.abstractmethod
    def lookup(self, state: Any, ids: torch.Tensor, spec: EmbeddingSpec,
               grad_scale: float = 1.0) -> torch.Tensor:
        """De-quantized / fake-quantized / masked rows [..., d] for ``ids``
        (``grad_scale``: LSQ's step-gradient scale, QAT only)."""

    @abc.abstractmethod
    def memory_bytes(self, state: Any, spec: EmbeddingSpec, *, training: bool = True,
                     stored: bool = False) -> int:
        """Embedding bytes (paper Table 1's compression columns): in training,
        or (``training=False``) what inference ships; container-actual for
        codes.  ``stored`` (training only) counts every tensor of the state
        as the device holds it: the row-optimizer slots of integer tables,
        and prune's bool mask at one byte per weight where the paper counts
        one bit."""

    def serving_state(self, state: Any, spec: EmbeddingSpec):
        """What a serving Engine keeps resident: the fp32 export of the
        evaluation table by default (optimizer and mask state dropped)."""
        with torch.no_grad():
            return serving_tbl.FloatTable(self.eval_table(state, spec))

    @abc.abstractmethod
    def trainable_params(self, state: Any, spec: EmbeddingSpec) -> Any:
        """Differentiable leaves (None for integer tables)."""

    @abc.abstractmethod
    def with_params(self, state: Any, params: Any, spec: EmbeddingSpec) -> Any:
        """Rebuild state from updated differentiable leaves."""

    # ---------------------------------------------------- dense formulation

    def dense_params(self, state: Any, spec: EmbeddingSpec) -> torch.Tensor:
        """The tensor the dense (LM, data-parallel) backward differentiates w.r.t."""
        return self.trainable_params(state, spec)

    def dense_lookup(self, state: Any, params: Any, ids: torch.Tensor,
                     spec: EmbeddingSpec) -> torch.Tensor:
        """Rows for ``ids``, differentiable in ``params`` (laid out as
        :meth:`dense_params`)."""
        return self.lookup(self.with_params(state, params, spec), ids, spec)

    def dense_table_from(self, state: Any, params: Any, spec: EmbeddingSpec) -> torch.Tensor:
        """Full [n, d] float table, differentiable in ``params``."""
        ids = torch.arange(spec.n, device=tree_leaves(params)[0].device)
        return self.lookup(self.with_params(state, params, spec), ids, spec)

    def eval_table(self, state: Any, spec: EmbeddingSpec) -> torch.Tensor:
        """The [n, d] table evaluation forwards read (training semantics)."""
        return self.dense_table_from(state, self.dense_params(state, spec), spec)

    def dense_update(self, state: Any, opt: Any, grads: torch.Tensor, *, spec: EmbeddingSpec,
                     lr: float, weight_decay: float, noise: torch.Tensor | None = None,
                     delta_grad: Callable | None = None, batch_rows: int | None = None):
        """Consume the dense gradient -> ``(new_state, new_opt, aux)``.

        The float-leaf rule: AdamW over ``trainable_params`` with decoupled
        weight decay (``grads`` laid out as those params; ``opt`` the
        caller-held ``OptState`` over their ``tree_leaves``, the reference's
        pytree order; one ``adam_update`` launch on the card).  ``noise`` is
        the step's SR draw of an integer table (one tensor per sub-table of
        a composed one); ``delta_grad(w_new, step_vec, gscale) -> g_step``
        and ``batch_rows`` (the paper's b) serve methods that learn Delta."""
        params = self.trainable_params(state, spec)
        new, new_opt = adam_update(tree_leaves(grads), opt, tree_leaves(params), lr,
                                   weight_decay=weight_decay, use_kernel=spec.use_kernels)
        return self.with_params(state, tree_like(params, new), spec), new_opt, {}

    def dense_noise(self, generator: torch.Generator, state: Any, spec: EmbeddingSpec):
        """The SR draw ``dense_update`` consumes, from ``generator``: None
        for float leaves; an integer table's [n_alloc, d_alloc] draw."""
        return None

    # ---------------------------------------------------- host-side refresh

    def host_sync(self, state: Any, step: int, spec: EmbeddingSpec) -> Any:
        """Cheap host-side per-step state sync (the schedule clock)."""
        return state

    def host_refresh(self, state: Any, spec: EmbeddingSpec) -> Any:
        """Periodic refresh (DeepLight's mask recomputation)."""
        raise NotImplementedError(f"{self.name!r} has no host refresh")

    def refresh_every(self, spec: EmbeddingSpec) -> int:
        raise NotImplementedError(f"{self.name!r} has no host refresh")

    def after_step(self, state: Any, step: int, spec: EmbeddingSpec) -> Any:
        """What a trainer's host does after its step ``step`` (the count of
        steps taken) for a ``has_host_refresh`` method: :meth:`host_sync`
        the clock, then :meth:`host_refresh` every :meth:`refresh_every`
        steps (both trainers' ``wrap_host_refresh``)."""
        state = self.host_sync(state, step, spec)
        if step % self.refresh_every(spec) == 0:
            state = self.host_refresh(state, spec)
        return state

    def dense_delta_grad(self, w_new, step_vec, loss_fn_q, *, spec: EmbeddingSpec,
                         weight_decay: float, gscale: float) -> torch.Tensor:
        raise NotImplementedError(f"{self.name!r} has no learned step size")

    def storage_spec(self, spec: EmbeddingSpec) -> tuple[CacheSlot, ...]:
        """The cacheable sub-tables of the training state (the hot-row cache
        hook, :mod:`repro_torch.storage`): one :class:`CacheSlot` per table of
        integer codes inside the state.  Float-leaf methods have none."""
        return ()

    # -------------------------------------------------- sharding

    def table_pspec(self, row, col, *, row_optimizer: str = "adam"):
        """Spec tree mirroring the state (:mod:`repro_torch.dist.sharding`);
        ``row`` / ``col`` are the mesh-axis entries the caller chose
        (divisibility-guarded)."""
        return P(row, col)

    def param_pspec(self, row, col):
        """Spec tree mirroring ``trainable_params`` (None for integer tables:
        they carry no float-leaf optimizer state)."""
        return P(row, col)

    def fused_row_step(self, state: Any, ids: torch.Tensor, *, spec: EmbeddingSpec,
                       loss_from_rows: Callable, dense_params: list,
                       update_dense: Callable, lr: float, weight_decay: float,
                       noise: list):
        """Single-device train step of an integer table (row formulation).

        ``loss_from_rows(rows) -> scalar`` closes over the batch and reads
        the dense model's *current* parameters ``dense_params``;
        ``update_dense(grads)`` steps them in place.  ``noise`` holds
        ``noise_draws(spec)`` SR draws [K, d].  Returns ``(new_state, metrics)``.
        """
        raise NotImplementedError(
            f"{self.name!r} has no row formulation; use the float-leaf path")


class IntegerTableMethod(EmbeddingMethod):
    """Base for methods whose table is integer codes + per-row Delta.

    Subclasses supply ``sparse_apply`` (paper Eq. 8 on the touched rows) and
    inherit a fused row step: one backward w.r.t. (looked-up rows, dense
    params), the dense update, then the sparse row update.
    """

    is_integer_table = True

    def noise_draws(self, spec):
        return 1

    def dense_noise(self, generator, state, spec):
        return quant.sr_noise(generator, tuple(state.codes.shape))

    def trainable_params(self, state, spec):
        return None

    def with_params(self, state, params, spec):
        return state

    def checkpoint_schema(self, spec):
        return lpt_core.schema(spec.n_padded, spec.d_padded, spec.bits,
                               optimizer=spec.row_optimizer, packed=spec.packed)

    def param_pspec(self, row, col):
        return None

    @abc.abstractmethod
    def dense_table(self, state: Any, spec: EmbeddingSpec) -> torch.Tensor:
        """The full de-quantized live [n, d] table."""

    def dense_params(self, state, spec):
        return self.dense_table(state, spec)

    def dense_lookup(self, state, params, ids, spec):
        """Rows for ``ids``, differentiable in the dense [n, d] ``params``.

        The forward reads the codes through :meth:`lookup` (with kernels on,
        ``dequant_gather`` at one byte a code in place of the fp32 table),
        bitwise ``params[ids]`` since ``params`` is the de-quantized table;
        the backward is the exact transpose of the take, the occurrence-order
        ``segment_sum`` into zeros of ``params``' shape (the reference's
        custom VJP, ``repro/methods/base.py:354``).  ``index_add_`` on the
        card would add in no fixed order.
        """
        return _DenseLookup.apply(params, self, state, ids, spec)

    def dense_table_from(self, state, params, spec):
        return params

    @abc.abstractmethod
    def sparse_apply(self, state: Any, ids: torch.Tensor, g_rows: torch.Tensor, *,
                     spec: EmbeddingSpec, lr: float, weight_decay: float,
                     noise: torch.Tensor) -> Any:
        """Row update from per-occurrence cotangents (paper Eq. 8), in place;
        ``noise`` is :meth:`sparse_noise` of the step's draws."""

    def row_grads(self, state, ids, *, spec, loss_from_rows, dense_params):
        """``(loss, g_rows, g_dense)``: one forward/backward at the batch's rows."""
        rows = self.lookup(state, ids, spec).detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_from_rows(rows)
            g_rows, *g_dense = torch.autograd.grad(loss, [rows, *dense_params])
        return loss.detach(), g_rows, g_dense

    def fused_row_step(self, state, ids, *, spec, loss_from_rows, dense_params,
                       update_dense, lr, weight_decay, noise):
        loss, g_rows, g_dense = self.row_grads(state, ids, spec=spec,
                                               loss_from_rows=loss_from_rows,
                                               dense_params=dense_params)
        update_dense(g_dense)
        new_state = self.sparse_apply(state, ids, g_rows, spec=spec, lr=lr,
                                      weight_decay=weight_decay,
                                      noise=self.sparse_noise(noise))
        return new_state, {"loss": loss}

    def storage_spec(self, spec):
        """The identity slot of a state that *is* one ``LPTTable`` (lpt,
        alpt); the composed methods override it."""
        return (CacheSlot(name="table", rows=spec.n, get=lambda s: s, put=lambda s, t: t,
                          local_ids=np.asarray),)

    def sparse_noise(self, noise: list):
        """What ``sparse_apply`` takes of the step's draws: a single table's
        one tensor (composed tables take the list, one per sub-table)."""
        return noise[0]

    def serving_state(self, state, spec):
        """int8-resident serving export: the codes + per-row Delta as they are.

        Nothing is de-quantized here: the Engine reads rows through
        ``ops.dequant_gather``, so the fp32 table never exists.
        """
        return serving_tbl.QuantTable(
            codes=state.codes, step=state.step, n=spec.n, d=spec.d,
            use_kernels=spec.use_kernels,
        )


class _DenseLookup(torch.autograd.Function):
    """``method.lookup(state, ids)`` as a function of the dense table
    ``params`` (it equals ``params[ids]``); backward: ``segment_sum``."""

    @staticmethod
    def forward(ctx, params, method, state, ids, spec):
        ctx.save_for_backward(ids)
        ctx.n = params.shape[0]
        if not spec.use_kernels:
            return params[ids.to(torch.int64)]
        return method.lookup(state, ids, spec)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1).to(torch.int64)
        g_table = ref.segment_sum(g.reshape(flat.numel(), -1), flat, ctx.n)
        return g_table, None, None, None, None


_REGISTRY: dict[str, EmbeddingMethod] = {}


def register(name: str):
    """Class decorator: instantiate and register under ``name``."""

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"embedding method {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def get(name: str) -> EmbeddingMethod:
    """The registered method instance for ``name`` (ValueError if unknown)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown embedding method {name!r}; registered: {available()}"
        ) from None


def available() -> tuple[str, ...]:
    """Sorted names of every registered method."""
    return tuple(sorted(_REGISTRY))
