"""Adaptive low-precision training (port of repro/core/alpt.py, config only).

Serving reads a table's learned Delta as it is, so this slice carries only
:class:`ALPTConfig`, which :class:`~repro_torch.methods.base.EmbeddingSpec`
holds.  ``alpt_step`` and the dense sub-steps come with training.
"""
from __future__ import annotations

from typing import NamedTuple


class ALPTConfig(NamedTuple):
    bits: int = 8
    rounding: str = "sr"  # rounding for the write-back (paper: SR)
    optimizer: str = "adam"  # row optimizer for the embeddings
    weight_decay: float = 5e-8  # paper: 5e-8 Avazu / 1e-5 Criteo
    step_lr: float = 2e-5  # paper: Delta learning rate 2e-5
    step_weight_decay: float = 5e-8  # paper: same decay as embeddings (8-bit)
    grad_scale: str = "bdq"  # '1' | 'dq' | 'bdq'  (Fig. 4 sweep)
    use_kernels: bool = False
    step_clamp: float | None = None
