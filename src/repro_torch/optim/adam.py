"""Adam and SGD over a list of float32 tensors (port of repro/optim/adam.py).

Not ``torch.optim.Adam``: the reference's update is ``(m / bc1) / (sqrt(v /
bc2) + eps)``, and PyTorch's orders it otherwise.  The arithmetic is
:func:`repro_torch.kernels.ref.adam_update_ref` (the reference's as XLA:CPU
compiles it inside the jitted train step; tests/test_torch_train_kernels.py
holds it bitwise), and on the card the ``adam_update`` kernel, which equals
it bit for bit.  ``OptState.mu`` / ``nu`` follow the order of the parameter
list (for the DCN, ``module.parameters()``; for the transformer's nested
param dict, :func:`tree_leaves`, the reference's pytree order).
:func:`sgd_update` is the reference's plain SGD, and :func:`make_optimizer`
picks either by name.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.lpt import adam_bias_corrections
from repro_torch.kernels import ops, ref


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
                use_kernel: bool = True, inplace: bool = False):
    """One AdamW step -> ``(new_params, new_state)``, new tensors throughout,
    or (``inplace``) ``params`` and ``state``'s moments overwritten, bitwise
    the same values; ``lr`` is rounded to float32, as the reference holds
    it.  CUDA tensors take the ``adam_update`` kernel unless ``use_kernel``
    is False."""
    step = state.step + 1
    bc1, bc2 = adam_bias_corrections(step, b1, b2)
    params = [p.detach() for p in params]
    new_p, new_m, new_v = ops.adam_update(params, list(grads), state.mu, state.nu, lr, bc1, bc2,
                                          b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                                          use_kernel=use_kernel, inplace=inplace)
    return new_p, OptState(step=step, mu=new_m, nu=new_v)


def sgd_init(params) -> OptState:
    """SGD keeps no moments."""
    return OptState(step=0, mu=(), nu=())


@torch.no_grad()
def sgd_update(grads, state: OptState, params, lr: float, *, weight_decay: float = 0.0):
    """One SGD step -> ``(new_params, new_state)``: ``p - lr * (g + wd * p)``
    as XLA:CPU compiles the reference's, ``fma(-lr, fma(wd, p, g), p)``
    (``fma(-lr, g, p)`` without decay); ``lr`` and ``weight_decay`` rounded
    to float32."""
    neg_lr, wd = -ref.f32(lr), ref.f32(weight_decay)
    new = []
    for p, g in zip(params, grads, strict=True):
        p32, g32 = p.detach().to(torch.float32), g.to(torch.float32)
        if weight_decay:
            g32 = ref.fma(wd, p32, g32)
        new.append(ref.fma(neg_lr, g32, p32).to(p.dtype))
    return new, OptState(step=state.step + 1, mu=(), nu=())


def make_optimizer(name: str):
    """``(init_fn, update_fn)`` for ``'adam'`` | ``'adamw'`` | ``'sgd'``."""
    if name in ("adam", "adamw"):
        return adam_init, adam_update
    if name == "sgd":
        return sgd_init, sgd_update
    raise ValueError(f"unknown optimizer {name!r}")


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list tree in JAX's flatten order: dict
    keys sorted, lists in order (so a reference ``OptState`` over the same
    tree lines up leaf for leaf)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_like(tree, leaves):
    """``tree``'s structure with its tensors replaced by ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            built = {k: build(x[k]) for k in sorted(x)}  # consume leaves in sorted order
            return {k: built[k] for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return next(it)

    return build(tree)


def clip_by_global_norm(grads: list, max_norm: float, *, inplace: bool = False,
                        split: list | None = None, groups: dict | None = None):
    """``(grads * min(1, max_norm / (||grads|| + 1e-12)), ||grads||)`` over a
    list of tensors, the global norm a 0-d tensor (no host sync);
    ``inplace`` scales ``grads`` themselves (float32) and returns them.

    ``split`` (one entry a leaf: the mesh axes that cut it, empty for a
    replicated leaf) marks the leaves that are this rank's block: the
    squares of the leaves cut by the same axes are summed over that key's
    process group in ``groups`` (all-gathered, added in rank order, so
    every rank gets the same norm bitwise), the replicated leaves' counted
    once, so the norm is the whole tree's."""
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
    if split is None:
        gnorm = torch.sqrt(sum(sq))
    else:
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        total = sum((q for q, axes in zip(sq, split, strict=True) if not axes), zero)
        for key in sorted({axes for axes in split if axes}):
            part = sum((q for q, axes in zip(sq, split) if axes == key), zero).reshape(1)
            parts = [torch.empty_like(part) for _ in range(dist.get_world_size(groups[key]))]
            dist.all_gather(parts, part, group=groups[key])
            ordered = parts[0]
            for p in parts[1:]:
                ordered = ordered + p
            total = total + ordered[0]
        gnorm = torch.sqrt(total)
    scale = torch.clamp_max(max_norm / (gnorm + 1e-12), 1.0)
    if inplace:
        return [g.mul_(scale) for g in grads], gnorm
    return [(g * scale).to(g.dtype) for g in grads], gnorm
