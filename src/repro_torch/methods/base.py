"""The `EmbeddingMethod` protocol + registry (port of repro/methods/base.py).

Every consumer dispatches on ``spec.method`` through :func:`get`.  This slice
ports the serving surface of a method — ``init`` / ``lookup`` /
``memory_bytes`` / ``serving_state`` — for ``fp``, ``lpt`` and ``alpt``; the
training formulations (``fused_row_step``, ``sparse_apply``, the dense path)
come with the training slice.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any

import torch

from repro_torch.core.alpt import ALPTConfig
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


class IntegerTableMethod(EmbeddingMethod):
    """Base for methods whose table is integer codes + per-row Delta."""

    is_integer_table = True

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
