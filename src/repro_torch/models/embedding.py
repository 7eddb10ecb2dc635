"""One embedding-table API over all methods, a thin shim over
:mod:`repro_torch.methods` (port of repro/models/embedding.py).

The function-style entry points ``init_embedding`` / ``lookup`` /
``trainable_params`` / ``with_params`` / ``memory_bytes`` delegate to the
registered method of ``spec.method``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.methods import EmbeddingSpec, available, get  # noqa: F401

__all__ = ["EmbeddingSpec", "available", "get", "init_embedding", "lookup",
           "trainable_params", "with_params", "memory_bytes"]


def init_embedding(generator: torch.Generator, spec: EmbeddingSpec) -> Any:
    return get(spec.method).init(generator, spec)


def lookup(state: Any, ids: torch.Tensor, spec: EmbeddingSpec,
           grad_scale: float = 1.0) -> torch.Tensor:
    """De-quantized / fake-quantized / masked rows [..., d]."""
    return get(spec.method).lookup(state, ids, spec, grad_scale=grad_scale)


def trainable_params(state: Any, spec: EmbeddingSpec):
    """Differentiable leaves of float-leaf methods (None for integer tables)."""
    return get(spec.method).trainable_params(state, spec)


def with_params(state: Any, params: Any, spec: EmbeddingSpec):
    """Rebuild the state from updated differentiable leaves."""
    return get(spec.method).with_params(state, params, spec)


def memory_bytes(state: Any, spec: EmbeddingSpec, *, training: bool) -> int:
    """Embedding-memory accounting as in paper Table 1's compression columns."""
    return get(spec.method).memory_bytes(state, spec, training=training)
