"""A method's table state to and from the reference's layout.

The reference's state ``NamedTuple`` crosses as nested dicts of arrays
(``_asdict`` at every level, a ``CodeStore`` as its ``data`` bytes, the
mixed table's ``subs`` a list): the layout a checkpoint's tree restores to
and the one the JAX package's states take once converted to numpy.
:func:`emb_state_from_numpy` builds the port's state of ``spec.method``
from it, :func:`emb_state_to_numpy` gives it back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import hashing, pruning, qat
from repro_torch.core.codestore import CodeStore, is_packable, packed_width
from repro_torch.core.lpt import LPTTable
from repro_torch.methods.base import EmbeddingSpec
from repro_torch.methods.mixed import MixedTable, plan_of
from repro_torch.methods.qr_lpt import QRLPTTable


def as_tensor(a, dtype, dev) -> torch.Tensor:
    """A numpy array (copied) or a tensor (moved, no copy if in place) as
    ``dtype`` on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.array(a), dtype=dtype).to(dev)


def codes_and_step(spec: EmbeddingSpec, codes, step, dev) -> tuple[CodeStore, torch.Tensor]:
    """The reference ``CodeStore.data`` (uint8 ``[n, ceil(d*bits/8)]`` when
    packed, int8 ``[n, d]`` otherwise, at the spec's allocated geometry; a
    numpy array or a tensor) and its Delta, checked and on ``dev``."""
    n, d = spec.n_padded, spec.d_padded
    if not isinstance(codes, torch.Tensor):
        codes = torch.from_numpy(np.array(codes))
    packed = codes.dtype == torch.uint8
    if packed:
        if not is_packable(spec.bits):
            raise ValueError(f"packed codes at bits={spec.bits}")
        expect = (n, packed_width(d, spec.bits))
    else:
        if codes.dtype != torch.int8:
            raise ValueError(f"codes must be int8 or packed uint8, got {codes.dtype}")
        expect = (n, d)
    if tuple(codes.shape) != expect:
        raise ValueError(f"codes shape {tuple(codes.shape)} != {expect}")
    step = as_tensor(step, torch.float32, dev)
    if tuple(step.shape) != (n,):
        raise ValueError(f"step shape {tuple(step.shape)} != ({n},)")
    store = CodeStore(data=codes.to(dev), bits=spec.bits, n=n, d=d, packed=packed)
    return store, step


def _lpt_from_numpy(tree: dict, bits: int, d: int, dev) -> LPTTable:
    """A reference ``LPTTable`` as ``{"codes", "step", "mu", "nu", "count"}``
    (``codes`` the container bytes, or ``{"data": bytes}`` as a checkpoint
    tree holds them) at width ``d``, rows from ``step``."""
    geometry = EmbeddingSpec(method="lpt", n=int(np.shape(tree["step"])[0]), d=d, bits=bits)
    codes = tree["codes"]["data"] if isinstance(tree["codes"], dict) else tree["codes"]
    store, step_t = codes_and_step(geometry, codes, tree["step"], dev)
    return LPTTable(codes=store, step=step_t, mu=as_tensor(tree["mu"], torch.float32, dev),
                    nu=as_tensor(tree["nu"], torch.float32, dev), count=int(tree["count"]))


def lpt_to_numpy(table: LPTTable) -> dict:
    def cpu(t):
        return t.detach().cpu().numpy()

    return {"codes": cpu(table.codes.data), "step": cpu(table.step), "mu": cpu(table.mu),
            "nu": cpu(table.nu), "count": int(table.count)}


def emb_state_from_numpy(spec: EmbeddingSpec, tree, *,
                         device: str | torch.device = "cuda"):
    """The port's table state of ``spec.method`` for the reference's state in
    the module docstring's layout: fp an array; lpt / alpt an ``LPTTable``
    dict; lsq / pact ``{"weights", "scale"}``; hash ``{"remainder",
    "quotient", "r"}``; prune ``{"weights", "mask", "step"}``; qr_lpt /
    qr_alpt ``{"remainder", "quotient", "r"}`` of ``LPTTable`` dicts; mixed
    ``{"subs": [LPTTable dict per group]}``.  Leaves are numpy arrays or
    tensors."""
    dev = device_mod.resolve(device)

    def tensor(a, dtype=torch.float32):
        return as_tensor(a, dtype, dev)

    name, d = spec.method, spec.d_padded
    if name == "fp":
        return tensor(tree)
    if name in ("lpt", "alpt"):
        return _lpt_from_numpy(tree, spec.bits, d, dev)
    if name in ("lsq", "pact"):
        return qat.QATTable(weights=tensor(tree["weights"]), scale=tensor(tree["scale"]))
    if name == "hash":
        return hashing.QRTable(remainder=tensor(tree["remainder"]),
                               quotient=tensor(tree["quotient"]), r=int(tree["r"]))
    if name == "prune":
        return pruning.PruneState(weights=tensor(tree["weights"]),
                                  mask=tensor(tree["mask"], torch.bool), step=int(tree["step"]))
    if name in ("qr_lpt", "qr_alpt"):
        return QRLPTTable(remainder=_lpt_from_numpy(tree["remainder"], spec.bits, d, dev),
                          quotient=_lpt_from_numpy(tree["quotient"], spec.bits, d, dev),
                          r=int(tree["r"]))
    if name == "mixed":
        bits = plan_of(spec).group_bits
        if len(tree["subs"]) != len(bits):
            raise ValueError(f"{len(tree['subs'])} sub-tables for {len(bits)} bit groups")
        return MixedTable(subs=tuple(_lpt_from_numpy(t, b, d, dev)
                                     for t, b in zip(tree["subs"], bits)))
    raise ValueError(f"no numpy layout for method {name!r}")


def emb_state_to_numpy(state):
    """The inverse of :func:`emb_state_from_numpy`."""
    def cpu(x):
        if isinstance(x, LPTTable):
            return lpt_to_numpy(x)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return {k: cpu(v) for k, v in x._asdict().items()}
        if isinstance(x, tuple):
            return [cpu(v) for v in x]
        return x

    return cpu(state)
