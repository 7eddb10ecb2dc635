"""Adam over a list of float32 tensors (port of repro/optim/adam.py).

Not ``torch.optim.Adam``: the reference's update is ``(m / bc1) / (sqrt(v /
bc2) + eps)``, and PyTorch's orders it otherwise.  The arithmetic is
:func:`repro_torch.kernels.ref.adam_update_ref` (the reference's as XLA:CPU
compiles it inside the jitted train step; tests/test_torch_train_kernels.py
holds it bitwise), and on the card the ``adam_update`` kernel, which equals
it bit for bit.  ``OptState.mu`` / ``nu`` follow the order of the parameter
list (for the DCN, ``module.parameters()``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.lpt import adam_bias_corrections
from repro_torch.kernels import ops


class OptState(NamedTuple):
    step: int
    mu: list  # first moments, one f32 tensor per parameter
    nu: list  # second moments


def adam_init(params) -> OptState:
    return OptState(
        step=0,
        mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        nu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
    )


@torch.no_grad()
def adam_update(grads, state: OptState, params, lr: float, *, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                use_kernel: bool = True):
    """One AdamW step -> ``(new_params, new_state)``, new tensors throughout;
    ``lr`` is rounded to float32, as the reference holds it.  CUDA tensors
    take the ``adam_update`` kernel unless ``use_kernel`` is False."""
    step = state.step + 1
    bc1, bc2 = adam_bias_corrections(step, b1, b2)
    params = [p.detach() for p in params]
    new_p, new_m, new_v = ops.adam_update(params, list(grads), state.mu, state.nu, lr, bc1, bc2,
                                          b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                                          use_kernel=use_kernel)
    return new_p, OptState(step=step, mu=new_m, nu=new_v)
