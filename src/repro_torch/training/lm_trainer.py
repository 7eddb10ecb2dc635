"""LM trainer state with a registry-dispatched vocab embedding table (port
of repro/training/lm_trainer.py, the serving half).

Ported: :class:`LMTrainerConfig`, :func:`embedding_spec_of` and
:func:`init_state` (the transformer params and the ALPT / LPT vocab table,
the table's init quantize through the ``sr_round`` kernel).  The optimizer
states and the training step (``lpt.dense_apply`` / ``alpt_dense_step``
through ``lpt_fused_update``) come with the LM training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import device as device_mod
from repro_torch import methods
from repro_torch.core.alpt import ALPTConfig
from repro_torch.models import transformer as tfm


class LMTrainState(NamedTuple):
    """The serving half of the reference's state: the optimizer slots and the
    step's generator come with the training slice."""

    params: Any  # transformer blocks (+ untied head)
    table: Any  # embedding-method state (an LPTTable for lpt/alpt)
    step: int


@dataclasses.dataclass(frozen=True)
class LMTrainerConfig:
    """The reference's settings that the vocab table reads; the dense
    optimizer's, the DP sync's and the guard's come with the training step."""

    emb_weight_decay: float = 5e-8  # paper's embedding decay
    row_optimizer: str = "adam"
    alpt_step_lr: float = 2e-5


def embedding_spec_of(cfg: tfm.ModelConfig,
                      tcfg: LMTrainerConfig | None = None) -> methods.EmbeddingSpec:
    """The vocab table as an :class:`~repro_torch.methods.EmbeddingSpec`."""
    tcfg = LMTrainerConfig() if tcfg is None else tcfg
    return methods.EmbeddingSpec(
        method=cfg.embedding_method,
        n=cfg.vocab_size,
        d=cfg.d_model,
        bits=cfg.embedding_bits,
        init_scale=cfg.d_model**-0.5,
        row_optimizer=tcfg.row_optimizer,
        alpt=ALPTConfig(
            bits=cfg.embedding_bits,
            rounding="sr",
            optimizer=tcfg.row_optimizer,
            weight_decay=tcfg.emb_weight_decay,
            step_lr=tcfg.alpt_step_lr,
        ),
    )


def init_state(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig | None = None, *, seed: int = 0,
               device: str | torch.device = "cuda") -> LMTrainState:
    """Params, then the vocab table, drawn from one generator seeded with
    ``seed`` on ``device`` (``cuda`` unless the caller asks for the CPU;
    raises if CUDA is asked for and absent).  The draws are torch's: a parity
    test carries the reference's state across through ``repro_torch.interop``."""
    dev = device_mod.resolve(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    params = tfm.init_params(generator, cfg)
    spec = embedding_spec_of(cfg, tcfg)
    table = methods.get(spec.method).init(generator, spec)
    return LMTrainState(params=params, table=table, step=0)
