"""Embedding-method protocol + registry (see :mod:`repro_torch.methods.base`).

Importing this package registers every ported method (fp, lpt, alpt).
"""
from repro_torch.methods.base import (  # noqa: F401
    EmbeddingMethod,
    EmbeddingSpec,
    IntegerTableMethod,
    available,
    get,
    register,
)

# Importing an implementation module registers its method.
from repro_torch.methods import alpt, fp, lpt  # noqa: E402,F401

__all__ = [
    "EmbeddingMethod",
    "EmbeddingSpec",
    "IntegerTableMethod",
    "available",
    "get",
    "register",
]
