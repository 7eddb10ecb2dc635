"""The `EmbeddingMethod` protocol + registry (port of repro/methods/base.py).

Every consumer dispatches on ``spec.method`` through :func:`get`.  Ported
for ``fp``, ``lpt`` and ``alpt``: the serving surface (``init`` / ``lookup``
/ ``memory_bytes`` / ``serving_state``), the float-leaf formulation
(``trainable_params`` / ``with_params``), the sparse row formulation
(``sparse_apply`` / ``fused_row_step``, the CTR path) and the dense
formulation (``dense_params`` / ``dense_table_from`` / ``dense_update`` /
``dense_delta_grad``, the LM path: the gradient of the whole [n, d] table).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.alpt import ALPTConfig
from repro_torch.optim import adam_update
from repro_torch.serving import table as serving_tbl

#: Row/width multiple of ``pad_to_tiles``: the reference's sublane multiple,
#: kept so a padded reference state loads into the port with its geometry.
TILE = 8


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


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
    #: SR noise tensors [K, d] one ``fused_row_step`` consumes.
    noise_draws: int = 0

    @abc.abstractmethod
    def init(self, generator: torch.Generator, spec: EmbeddingSpec) -> Any:
        """Initialize the table state on ``generator.device``."""

    @abc.abstractmethod
    def lookup(self, state: Any, ids: torch.Tensor, spec: EmbeddingSpec) -> torch.Tensor:
        """De-quantized rows [..., d] for ``ids``."""

    @abc.abstractmethod
    def memory_bytes(self, state: Any, spec: EmbeddingSpec) -> int:
        """Embedding bytes the state holds (container-actual for codes)."""

    def serving_state(self, state: Any, spec: EmbeddingSpec):
        """What a serving Engine keeps resident: the fp table by default."""
        return serving_tbl.FloatTable(state)

    @abc.abstractmethod
    def trainable_params(self, state: Any, spec: EmbeddingSpec) -> Any:
        """Differentiable leaves (None for integer tables)."""

    @abc.abstractmethod
    def with_params(self, state: Any, params: Any, spec: EmbeddingSpec) -> Any:
        """Rebuild state from updated differentiable leaves."""

    # ---------------------------------------------------- dense formulation

    def dense_params(self, state: Any, spec: EmbeddingSpec) -> torch.Tensor:
        """The tensor the dense (LM) backward differentiates w.r.t."""
        return self.trainable_params(state, spec)

    @abc.abstractmethod
    def dense_table_from(self, state: Any, params: torch.Tensor,
                         spec: EmbeddingSpec) -> torch.Tensor:
        """Full [n, d] float table, differentiable in ``params``."""

    def eval_table(self, state: Any, spec: EmbeddingSpec) -> torch.Tensor:
        """The [n, d] table evaluation forwards read (training semantics)."""
        return self.dense_table_from(state, self.dense_params(state, spec), spec)

    def dense_update(self, state: Any, opt: Any, grads: torch.Tensor, *, spec: EmbeddingSpec,
                     lr: float, weight_decay: float, noise: torch.Tensor | None = None,
                     delta_grad: Callable | None = None, batch_rows: int | None = None):
        """Consume the dense gradient -> ``(new_state, new_opt, aux)``.

        The float-leaf rule: AdamW over ``trainable_params`` with decoupled
        weight decay (``opt`` the caller-held ``OptState`` over that one
        tensor; the ``adam_update`` kernel on the card).  ``noise`` is the
        step's SR draw of an integer table; ``delta_grad(w_new, step_vec,
        gscale) -> g_step`` and ``batch_rows`` (the paper's b) serve methods
        that learn Delta."""
        (new,), new_opt = adam_update([grads], opt, [self.trainable_params(state, spec)], lr,
                                      weight_decay=weight_decay, use_kernel=spec.use_kernels)
        return self.with_params(state, new, spec), new_opt, {}

    def dense_delta_grad(self, w_new, step_vec, loss_fn_q, *, spec: EmbeddingSpec,
                         weight_decay: float, gscale: float) -> torch.Tensor:
        raise NotImplementedError(f"{self.name!r} has no learned step size")

    def fused_row_step(self, state: Any, ids: torch.Tensor, *, spec: EmbeddingSpec,
                       loss_from_rows: Callable, dense_params: list,
                       update_dense: Callable, lr: float, weight_decay: float,
                       noise: list):
        """Single-device train step of an integer table (row formulation).

        ``loss_from_rows(rows) -> scalar`` closes over the batch and reads
        the dense model's *current* parameters ``dense_params``;
        ``update_dense(grads)`` steps them in place.  ``noise`` holds
        ``noise_draws`` SR draws [K, d].  Returns ``(new_state, metrics)``.
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
    noise_draws = 1

    def trainable_params(self, state, spec):
        return None

    def with_params(self, state, params, spec):
        return state

    @abc.abstractmethod
    def dense_table(self, state: Any, spec: EmbeddingSpec) -> torch.Tensor:
        """The full de-quantized live [n, d] table."""

    def dense_params(self, state, spec):
        return self.dense_table(state, spec)

    def dense_table_from(self, state, params, spec):
        return params

    @abc.abstractmethod
    def sparse_apply(self, state: Any, ids: torch.Tensor, g_rows: torch.Tensor, *,
                     spec: EmbeddingSpec, lr: float, weight_decay: float,
                     noise: torch.Tensor) -> Any:
        """Row update from per-occurrence cotangents (paper Eq. 8), in place."""

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
                                      weight_decay=weight_decay, noise=noise[0])
        return new_state, {"loss": loss}

    def serving_state(self, state, spec):
        """int8-resident serving export: the codes + per-row Delta as they are.

        Nothing is de-quantized here: the Engine reads rows through
        ``ops.dequant_gather``, so the fp32 table never exists.
        """
        return serving_tbl.QuantTable(
            codes=state.codes, step=state.step, n=spec.n, d=spec.d,
            use_kernels=spec.use_kernels,
        )


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
