"""Carry the reference's CTR trainer state, as numpy arrays, into the port and back.

The JAX package's ``TrainState`` crosses as plain numpy (the caller converts
it; this module never imports ``jax``): the code container's bytes, the
per-row Delta, the row-optimizer slots and the table's Adam ``count``, the
DCN parameter pytree, and the DCN's Adam state (``OptState`` step and the
``mu`` / ``nu`` pytrees, laid out as the parameters).  :func:`state_to_numpy`
returns the same layout, so a test can hold a whole trained state against
the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.codestore import CodeStore, is_packable, packed_width
from repro_torch.core.lpt import LPTTable
from repro_torch.models import ctr as ctr_models
from repro_torch.optim import OptState
from repro_torch.training.ctr_trainer import TrainerConfig, TrainState


def _dcn_tensors(cfg: TrainerConfig, tree: dict, dev) -> list[torch.Tensor]:
    """A pytree laid out as the DCN's parameters -> tensors in ``parameters()`` order."""
    module = ctr_models.DCN(cfg.dcn, device=dev).load_jax_params(tree)
    return [p.detach().clone() for p in module.parameters()]


def _dcn_tree(cfg: TrainerConfig, tensors) -> dict:
    module = ctr_models.DCN(cfg.dcn, device=tensors[0].device)
    with torch.no_grad():
        for p, t in zip(module.parameters(), tensors):
            p.copy_(t)
    return module.jax_params()


def state_from_numpy(cfg: TrainerConfig, *, codes: np.ndarray, step: np.ndarray,
                     dense_params: dict, mu: np.ndarray | None = None,
                     nu: np.ndarray | None = None, train_step: int = 0,
                     count: int | None = None, dense_opt: dict | None = None,
                     device: str | torch.device = "cuda") -> TrainState:
    """A port ``TrainState`` for an lpt/alpt reference state.

    ``codes`` is the reference ``CodeStore.data``: uint8 ``[n, ceil(d*bits/8)]``
    when packed, int8 ``[n, d]`` otherwise, at the spec's allocated geometry
    (``n_padded`` x ``d_padded``).  ``dense_params`` is the reference DCN
    pytree with numpy leaves.  ``count`` is the table's Adam step (default
    ``train_step``); ``dense_opt`` is ``{"step", "mu", "nu"}`` from the
    reference's dense ``OptState``.  Missing slots load as zeros.  The noise
    generator is seeded with ``cfg.seed``.
    """
    spec = cfg.spec
    if not spec.is_integer_table:
        raise ValueError(f"state_from_numpy loads integer tables; got {spec.method!r}")
    dev = device_mod.resolve(device)
    n, d = spec.n_padded, spec.d_padded
    codes = np.asarray(codes)
    packed = codes.dtype == np.uint8
    if packed:
        if not is_packable(spec.bits):
            raise ValueError(f"packed codes at bits={spec.bits}")
        expect = (n, packed_width(d, spec.bits))
    else:
        if codes.dtype != np.int8:
            raise ValueError(f"codes must be int8 or packed uint8, got {codes.dtype}")
        expect = (n, d)
    if codes.shape != expect:
        raise ValueError(f"codes shape {codes.shape} != {expect}")
    step = np.asarray(step, np.float32)
    if step.shape != (n,):
        raise ValueError(f"step shape {step.shape} != ({n},)")

    def tensor(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype).to(dev)

    slot = (n, d) if spec.row_optimizer == "adam" else (n,)
    table = LPTTable(
        codes=CodeStore(data=tensor(codes, torch.uint8 if packed else torch.int8),
                        bits=spec.bits, n=n, d=d, packed=packed),
        step=tensor(step, torch.float32),
        mu=tensor(np.zeros(slot, np.float32) if mu is None else mu, torch.float32),
        nu=tensor(np.zeros(slot, np.float32) if nu is None else nu, torch.float32),
        count=int(train_step if count is None else count),
    )
    dense = ctr_models.DCN(cfg.dcn, device=dev).load_jax_params(dense_params)
    if dense_opt is None:
        opt = OptState(step=0, mu=[torch.zeros_like(p) for p in dense.parameters()],
                       nu=[torch.zeros_like(p) for p in dense.parameters()])
    else:
        opt = OptState(step=int(dense_opt["step"]), mu=_dcn_tensors(cfg, dense_opt["mu"], dev),
                       nu=_dcn_tensors(cfg, dense_opt["nu"], dev))
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.seed)
    return TrainState(emb_state=table, dense=dense, step=int(train_step), dense_opt=opt,
                      generator=generator)


def state_to_numpy(cfg: TrainerConfig, state: TrainState) -> dict:
    """The inverse of :func:`state_from_numpy`: its keyword arguments as numpy."""
    table = state.emb_state

    def cpu(t):
        return t.detach().cpu().numpy()

    return {
        "codes": cpu(table.codes.data), "step": cpu(table.step), "mu": cpu(table.mu),
        "nu": cpu(table.nu), "count": int(table.count), "train_step": int(state.step),
        "dense_params": state.dense.jax_params(),
        "dense_opt": {"step": int(state.dense_opt.step),
                      "mu": _dcn_tree(cfg, state.dense_opt.mu),
                      "nu": _dcn_tree(cfg, state.dense_opt.nu)},
    }
