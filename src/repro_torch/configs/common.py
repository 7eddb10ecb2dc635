"""Shared machinery of the architecture configs (port of repro/configs/common.py).

Every config module exposes ``full_config(**overrides)`` (the published
shape) and ``smoke_config()`` (a reduced config of the same family).  The
dry-run shapes of the reference are TPU-mesh lowering targets and are not
ported; the configs added since the SSM / MoE slice keep the reference's
``SKIP_SHAPES`` (which of those shapes the architecture skips, and why) as a
record.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import ModelConfig

FULL_ATTN_LONG_SKIP = (
    "long_500k needs sub-quadratic attention; this arch is pure full attention "
    "(see DESIGN.md §4)"
)
ENCODER_DECODE_SKIP = "encoder-only arch has no autoregressive decode step"


def shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)
