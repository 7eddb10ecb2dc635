"""CTR trainer state (port of repro/training/ctr_trainer.py: config, state, init).

This slice serves a freshly initialized state, so it ports what builds one:
:class:`TrainerConfig`, :class:`TrainState` and :func:`init_state`.  The
train step, optimizer state, DeepFM and the hot-row cache come with the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import device as device_mod
from repro_torch import methods
from repro_torch.models import ctr as ctr_models


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    spec: methods.EmbeddingSpec
    dcn: ctr_models.DCNConfig
    seed: int = 0


class TrainState(NamedTuple):
    emb_state: Any  # the method's table state (an LPTTable for lpt/alpt)
    dense: ctr_models.DCN
    step: int


def init_state(cfg: TrainerConfig, *, device: str | torch.device = "cuda") -> TrainState:
    """Embedding table then DCN params, both drawn from one generator seeded
    with ``cfg.seed`` on ``device`` (``cuda`` unless the caller asks for the
    CPU; raises if CUDA is asked for and absent)."""
    dev = device_mod.resolve(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.seed)
    emb_state = methods.get(cfg.spec.method).init(generator, cfg.spec)
    dense = ctr_models.init_dcn(cfg.dcn, generator)
    return TrainState(emb_state=emb_state, dense=dense, step=0)
