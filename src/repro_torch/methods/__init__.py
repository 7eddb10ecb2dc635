"""Embedding-method protocol + registry (see :mod:`repro_torch.methods.base`).

Importing this package registers every method of the reference: fp, lpt,
alpt, lsq, pact, hash, prune, qr_lpt, qr_alpt and mixed.
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
from repro_torch.methods import (  # noqa: E402,F401
    alpt,
    fp,
    lpt,
    mixed,
    prune,
    qat,
    qr_hash,
    qr_lpt,
)

__all__ = [
    "EmbeddingMethod",
    "EmbeddingSpec",
    "IntegerTableMethod",
    "available",
    "get",
    "register",
]
