"""Carry the reference's states, as numpy arrays, into the port (and CTR back).

The JAX package's ``TrainState`` crosses as plain numpy (the caller converts
it; this module never imports ``jax``): the embedding state, the backbone's
parameter pytree (DCN or DeepFM), and their Adam states (``OptState`` step
and the ``mu`` / ``nu`` pytrees, laid out as the parameters).  For lpt /
alpt the table crosses as ``codes`` (the code container's bytes), ``step``,
``mu``, ``nu`` and ``count``; any method's state crosses as ``emb_state``,
the reference's state ``NamedTuple`` as nested dicts of numpy arrays
(``_asdict`` at every level, a ``CodeStore`` as its ``data`` bytes, the
mixed table's ``subs`` a list; :func:`emb_state_from_numpy`).
:func:`state_to_numpy` returns the same layout, so a test can hold a whole
trained state against the reference's.

For the LM slice, :func:`lm_params_from_numpy` carries the reference's
transformer params (``repro.models.transformer.init_params``, numpy leaves;
attention, ``mamba`` and ``moe`` blocks and the gelu MLP alike, their structure checked
against the config)
and :func:`quant_table_from_numpy` its serving table (codes + Delta, int8 or
packed) into the port's layouts; :func:`lm_state_from_numpy` its whole
``LMTrainState`` (params, their Adam state, the table with its row-Adam
slots and count, or the fp table and its Adam state, the step) and
:func:`lm_state_to_numpy` the port's back, in the same layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.lpt import LPTTable
from repro_torch.methods import EmbeddingSpec
from repro_torch.methods import get as get_method
from repro_torch.methods.layout import (  # noqa: F401  (the bridge's names)
    codes_and_step,
    emb_state_from_numpy,
    emb_state_to_numpy,
    lpt_to_numpy,
)
from repro_torch.models import ctr as ctr_models
from repro_torch.models import transformer as tfm
from repro_torch.optim import tree_like
from repro_torch.serving.table import QuantTable
from repro_torch.training import ctr_trainer, lm_trainer
from repro_torch.training.ctr_trainer import TrainerConfig, TrainState

#: The reference's LM params as the port's (``models.transformer``).
lm_params_from_numpy = tfm.params_from_numpy


def state_from_numpy(cfg: TrainerConfig, *, dense_params: dict, codes: np.ndarray | None = None,
                     step: np.ndarray | None = None, mu: np.ndarray | None = None,
                     nu: np.ndarray | None = None, train_step: int = 0,
                     count: int | None = None, dense_opt: dict | None = None,
                     emb_state=None, emb_opt: dict | None = None,
                     device: str | torch.device = "cuda") -> TrainState:
    """A port ``TrainState`` for a reference state.

    The table is either ``emb_state`` (any method, ``methods.layout``'s
    layout) or, for lpt / alpt, ``codes`` (the reference ``CodeStore.data``:
    uint8 ``[n, ceil(d*bits/8)]`` when packed, int8 ``[n, d]`` otherwise, at
    the spec's allocated geometry) with ``step``, ``mu``, ``nu`` and
    ``count`` (the table's Adam step, default ``train_step``; missing slots
    load as zeros).  ``dense_params`` is the reference backbone's pytree
    (DCN or DeepFM, as ``cfg.model``) with numpy leaves; ``dense_opt`` is
    ``{"step", "mu", "nu"}`` of its ``OptState``, ``emb_opt`` the same of a
    float-leaf method's (``mu`` / ``nu`` laid out as its trainable params);
    missing ones load as zeros.  The noise generator is seeded with
    ``cfg.seed``.
    """
    spec = cfg.spec
    dev = device_mod.resolve(device)
    if emb_state is None:
        if not spec.is_integer_table:
            raise ValueError(f"{spec.method!r} crosses as emb_state=, not codes=")
        n, d = spec.n_padded, spec.d_padded
        slot = (n, d) if spec.row_optimizer == "adam" else (n,)
        emb_state = {"codes": codes, "step": step,
                     "mu": np.zeros(slot, np.float32) if mu is None else mu,
                     "nu": np.zeros(slot, np.float32) if nu is None else nu,
                     "count": int(train_step if count is None else count)}
    tree = {"emb_state": emb_state, "dense_params": dense_params, "dense_opt": dense_opt,
            "emb_opt": emb_opt, "step": train_step}
    state = ctr_trainer.state_from_checkpoint(cfg, tree, device=dev)
    return state._replace(generator=torch.Generator(device=dev).manual_seed(cfg.seed))


def state_to_numpy(cfg: TrainerConfig, state: TrainState) -> dict:
    """The inverse of :func:`state_from_numpy`: its keyword arguments as numpy
    (``codes`` ... ``count`` for lpt / alpt, ``emb_state`` otherwise)."""
    table = state.emb_state
    out = {"train_step": int(state.step), "dense_params": state.dense.jax_params(),
           "dense_opt": {"step": int(state.dense_opt.step),
                         **{k: ctr_models.params_like(state.dense,
                                                      [t.cpu().numpy() for t in v])
                            for k, v in (("mu", state.dense_opt.mu),
                                         ("nu", state.dense_opt.nu))}}}
    if isinstance(table, LPTTable):
        out.update(lpt_to_numpy(table))
    else:
        out["emb_state"] = emb_state_to_numpy(table)
    if state.emb_opt is not None:
        params = get_method(cfg.spec.method).trainable_params(table, cfg.spec)
        out["emb_opt"] = {"step": int(state.emb_opt.step),
                          **{k: tree_like(params, [t.detach().cpu().numpy() for t in v])
                             for k, v in (("mu", state.emb_opt.mu), ("nu", state.emb_opt.nu))}}
    return out


def quant_table_from_numpy(spec: EmbeddingSpec, *, codes: np.ndarray, step: np.ndarray,
                           device: str | torch.device = "cuda") -> QuantTable:
    """The reference's int8-resident serving table (its ``QuantTable`` codes
    container bytes, int8 or packed, and Delta) as the port's."""
    dev = device_mod.resolve(device)
    store, step_t = codes_and_step(spec, codes, step, dev)
    return QuantTable(codes=store, step=step_t, n=spec.n, d=spec.d,
                      use_kernels=spec.use_kernels)


def lm_state_from_numpy(cfg: tfm.ModelConfig, tcfg: lm_trainer.LMTrainerConfig | None = None, *,
                        params: dict, table, opt: dict | None = None,
                        table_opt: dict | None = None, step: int = 0, seed: int = 0,
                        device: str | torch.device = "cuda") -> lm_trainer.LMTrainState:
    """A port ``LMTrainState`` for the reference's.

    ``params`` is the reference's param tree with numpy leaves; ``opt`` its
    Adam ``OptState`` as ``{"step", "mu", "nu"}`` with ``mu`` / ``nu`` trees
    laid out as ``params``.  ``table`` is the method's state in
    ``methods.layout``'s layout (lpt / alpt: ``{"codes", "step", "mu",
    "nu", "count"}``, ``codes`` the ``CodeStore.data`` bytes, int8 or packed
    uint8; fp: the [V, d] array), with ``table_opt`` the Adam state of a
    float-leaf method (``mu`` / ``nu`` laid out as its params).  Missing
    optimizer states load as zeros.  The SR noise generator is seeded with
    ``seed``.  Leaves are numpy arrays or tensors.
    """
    dev = device_mod.resolve(device)
    tree = {"params": params, "opt": opt, "table": table, "table_opt": table_opt, "step": step}
    state = lm_trainer.state_from_checkpoint(cfg, tree, tcfg, device=dev)
    return state._replace(generator=torch.Generator(device=dev).manual_seed(seed))


def lm_state_to_numpy(state: lm_trainer.LMTrainState) -> dict:
    """The inverse of :func:`lm_state_from_numpy`: its keyword arguments
    (``params``, ``opt``, ``table``, ``table_opt``, ``step``) as numpy."""
    def cpu(x):
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [cpu(v) for v in x]
        return x.detach().cpu().numpy()

    def opt(o, shape):
        return None if o is None else {"step": int(o.step), "mu": cpu(shape(o.mu)),
                                       "nu": cpu(shape(o.nu))}

    table, table_opt = state.table, opt(state.table_opt, lambda leaves: leaves[0])
    if isinstance(table, LPTTable):
        table = lpt_to_numpy(table)
    else:
        table = cpu(table)
    return {"params": cpu(state.params),
            "opt": opt(state.opt, lambda leaves: tree_like(state.params, leaves)),
            "table": table, "table_opt": table_opt, "step": int(state.step)}
