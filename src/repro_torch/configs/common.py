"""Shared machinery of the architecture configs (port of repro/configs/common.py).

Every config module exposes ``full_config(**overrides)`` (the published
shape) and ``smoke_config()`` (a reduced config of the same family).  The
dry-run shapes of the reference are TPU-mesh lowering targets and are not
ported.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import ModelConfig


def shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)
