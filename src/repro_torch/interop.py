"""Load the reference's CTR trainer state, given as numpy arrays, into the port.

The JAX package's ``TrainState`` crosses as plain numpy (the caller converts
it; this module never imports ``jax``): the code container's bytes, the
per-row Delta, optionally the row-optimizer slots, and the DCN parameter
pytree.  The result serves the same function as the reference state, which
is how the parity tests hold the whole slice against the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.codestore import CodeStore, is_packable, packed_width
from repro_torch.core.lpt import LPTTable
from repro_torch.models import ctr as ctr_models
from repro_torch.training.ctr_trainer import TrainerConfig, TrainState


def state_from_numpy(cfg: TrainerConfig, *, codes: np.ndarray, step: np.ndarray,
                     dense_params: dict, mu: np.ndarray | None = None,
                     nu: np.ndarray | None = None, train_step: int = 0,
                     device: str | torch.device = "cuda") -> TrainState:
    """A port ``TrainState`` for an lpt/alpt reference state.

    ``codes`` is the reference ``CodeStore.data``: uint8 ``[n, ceil(d*bits/8)]``
    when packed, int8 ``[n, d]`` otherwise, at the spec's allocated geometry
    (``n_padded`` x ``d_padded``).  ``dense_params`` is the reference DCN
    pytree with numpy leaves.  Missing optimizer slots load as zeros.
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
        count=int(train_step),
    )
    dense = ctr_models.DCN(cfg.dcn, device=dev).load_jax_params(dense_params)
    return TrainState(emb_state=table, dense=dense, step=int(train_step))
