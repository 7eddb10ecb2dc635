"""CUDA ``adam_update``: one AdamW step over a list of float32 tensors.

A helper of the training step (the dense model's optimizer), not the port of
a TPU kernel: the reference's ``repro/optim/adam.py:32`` is plain jnp that
XLA fuses.  The kernel is in ``csrc/adam_update.cu``, whose header says what
bounds it; one launch steps every tensor of the list.  Bitwise equal to
:func:`repro_torch.kernels.ref.adam_update_ref` on the same operands.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def adam_update(params, grads, mu, nu, lr: float, bc1: float, bc2: float, *,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0, inplace: bool = False):
    """``(new_params, new_mu, new_nu)`` for equal-length lists of contiguous
    float32 CUDA tensors on one device, each quadruple of one shape; the
    inputs are left as they are, or (``inplace``) ``params``, ``mu`` and
    ``nu`` are overwritten and returned (each thread reads its element
    before it writes it).  ``lr``, ``bc1`` and ``bc2`` are float32 values
    (host scalars, passed by value)."""
    params, grads, mu, nu = (list(x) for x in (params, grads, mu, nu))
    count = len(params)
    if not len(grads) == len(mu) == len(nu) == count:
        raise ValueError(f"adam_update: {count} params but {len(grads)} grads, {len(mu)} mu "
                         f"and {len(nu)} nu")
    if count == 0:
        return [], [], []
    dev = params[0].device if isinstance(params[0], torch.Tensor) else None
    for i, p in enumerate(params):
        shape = tuple(p.shape) if isinstance(p, torch.Tensor) else ()
        for name, t in (("param", p), ("grad", grads[i]), ("mu", mu[i]), ("nu", nu[i])):
            _build.check_operand("adam_update", f"{name} {i}", t, torch.float32, shape, dev)
    outs = ([params, list(mu), list(nu)] if inplace
            else [[torch.empty_like(p) for p in params] for _ in range(3)])
    tensors = [*params, *grads, *mu, *nu, *outs[0], *outs[1], *outs[2]]
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    sizes = (ctypes.c_int64 * count)(*(p.numel() for p in params))
    f = ref.f32
    with _build.on_device(dev):
        _build.launch("adam_update", "adam_update", "adam_update_launch", count, ptrs, sizes,
                      f(lr), f(bc1), f(bc2), f(b1), f(1.0 - b1), f(b2), f(1.0 - b2), f(eps),
                      f(weight_decay), _build.stream_of(dev))
    return outs[0], outs[1], outs[2]
