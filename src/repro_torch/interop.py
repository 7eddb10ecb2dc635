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
transformer params (``repro.models.transformer.init_params``, numpy leaves)
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
from repro_torch.core import hashing, pruning, qat
from repro_torch.core.codestore import CodeStore, is_packable, packed_width
from repro_torch.core.lpt import LPTTable
from repro_torch.methods import EmbeddingSpec
from repro_torch.methods import get as get_method
from repro_torch.methods.mixed import MixedTable, plan_of
from repro_torch.methods.qr_lpt import QRLPTTable
from repro_torch.models import ctr as ctr_models
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptState, adam_init, tree_leaves, tree_like
from repro_torch.serving.table import QuantTable
from repro_torch.training import lm_trainer
from repro_torch.training.ctr_trainer import TrainerConfig, TrainState


def _backbone(cfg: TrainerConfig, dev) -> torch.nn.Module:
    return ctr_models.MODELS[cfg.model][1](cfg.model_cfg, device=dev)


def _dcn_tensors(cfg: TrainerConfig, tree: dict, dev) -> list[torch.Tensor]:
    """A pytree laid out as the backbone's parameters -> tensors in
    ``parameters()`` order."""
    module = _backbone(cfg, dev).load_jax_params(tree)
    return [p.detach().clone() for p in module.parameters()]


def _dcn_tree(cfg: TrainerConfig, tensors) -> dict:
    module = _backbone(cfg, tensors[0].device)
    with torch.no_grad():
        for p, t in zip(module.parameters(), tensors):
            p.copy_(t)
    return module.jax_params()


def _codes_and_step(spec: EmbeddingSpec, codes: np.ndarray, step: np.ndarray,
                    dev) -> tuple[CodeStore, torch.Tensor]:
    """The reference ``CodeStore.data`` (uint8 ``[n, ceil(d*bits/8)]`` when
    packed, int8 ``[n, d]`` otherwise, at the spec's allocated geometry) and
    its Delta, checked and on ``dev``."""
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
    data = torch.from_numpy(np.array(codes)).to(dev)
    store = CodeStore(data=data, bits=spec.bits, n=n, d=d, packed=packed)
    return store, torch.from_numpy(np.array(step)).to(dev)


def _lpt_from_numpy(tree: dict, bits: int, d: int, dev) -> LPTTable:
    """A reference ``LPTTable`` as ``{"codes", "step", "mu", "nu", "count"}``
    (``codes`` the container bytes) at width ``d``, rows from ``step``."""
    step = np.asarray(tree["step"], np.float32)
    geometry = EmbeddingSpec(method="lpt", n=step.shape[0], d=d, bits=bits)
    store, step_t = _codes_and_step(geometry, tree["codes"], step, dev)

    def tensor(a):
        return torch.as_tensor(np.array(a), dtype=torch.float32).to(dev)

    return LPTTable(codes=store, step=step_t, mu=tensor(tree["mu"]), nu=tensor(tree["nu"]),
                    count=int(tree["count"]))


def _lpt_to_numpy(table: LPTTable) -> dict:
    def cpu(t):
        return t.detach().cpu().numpy()

    return {"codes": cpu(table.codes.data), "step": cpu(table.step), "mu": cpu(table.mu),
            "nu": cpu(table.nu), "count": int(table.count)}


def emb_state_from_numpy(spec: EmbeddingSpec, tree, *,
                         device: str | torch.device = "cuda"):
    """The port's table state of ``spec.method`` for the reference's state as
    numpy (the module docstring's layout): fp an array; lpt / alpt an
    ``LPTTable`` dict; lsq / pact ``{"weights", "scale"}``; hash
    ``{"remainder", "quotient", "r"}``; prune ``{"weights", "mask",
    "step"}``; qr_lpt / qr_alpt ``{"remainder", "quotient", "r"}`` of
    ``LPTTable`` dicts; mixed ``{"subs": [LPTTable dict per group]}``."""
    dev = device_mod.resolve(device)

    def tensor(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype).to(dev)

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
            return _lpt_to_numpy(x)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return {k: cpu(v) for k, v in x._asdict().items()}
        if isinstance(x, tuple):
            return [cpu(v) for v in x]
        return x

    return cpu(state)


def state_from_numpy(cfg: TrainerConfig, *, dense_params: dict, codes: np.ndarray | None = None,
                     step: np.ndarray | None = None, mu: np.ndarray | None = None,
                     nu: np.ndarray | None = None, train_step: int = 0,
                     count: int | None = None, dense_opt: dict | None = None,
                     emb_state=None, emb_opt: dict | None = None,
                     device: str | torch.device = "cuda") -> TrainState:
    """A port ``TrainState`` for a reference state.

    The table is either ``emb_state`` (any method, the module docstring's
    layout) or, for lpt / alpt, ``codes`` (the reference ``CodeStore.data``:
    uint8 ``[n, ceil(d*bits/8)]`` when packed, int8 ``[n, d]`` otherwise, at
    the spec's allocated geometry) with ``step``, ``mu``, ``nu`` and
    ``count`` (the table's Adam step, default ``train_step``; missing slots
    load as zeros).  ``dense_params`` is the reference backbone's pytree
    (DCN or DeepFM, as ``cfg.model``) with numpy leaves; ``dense_opt`` is
    ``{"step", "mu", "nu"}`` of its ``OptState``, ``emb_opt`` the same of a
    float-leaf method's (``mu`` / ``nu`` laid out as its trainable params).
    The noise generator is seeded with ``cfg.seed``.
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
    table = emb_state_from_numpy(spec, emb_state, device=dev)
    dense = _backbone(cfg, dev).load_jax_params(dense_params)
    if dense_opt is None:
        opt = OptState(step=0, mu=[torch.zeros_like(p) for p in dense.parameters()],
                       nu=[torch.zeros_like(p) for p in dense.parameters()])
    else:
        opt = OptState(step=int(dense_opt["step"]), mu=_dcn_tensors(cfg, dense_opt["mu"], dev),
                       nu=_dcn_tensors(cfg, dense_opt["nu"], dev))
    params = get_method(spec.method).trainable_params(table, spec)
    e_opt = None
    if params is not None:
        def leaves(tree):
            return [torch.as_tensor(np.array(a), dtype=torch.float32).to(dev)
                    for a in tree_leaves(tree)]

        e_opt = _opt_from_numpy(emb_opt, tree_leaves(params), leaves)
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.seed)
    return TrainState(emb_state=table, dense=dense, step=int(train_step), dense_opt=opt,
                      emb_opt=e_opt, generator=generator)


def state_to_numpy(cfg: TrainerConfig, state: TrainState) -> dict:
    """The inverse of :func:`state_from_numpy`: its keyword arguments as numpy
    (``codes`` ... ``count`` for lpt / alpt, ``emb_state`` otherwise)."""
    table = state.emb_state
    out = {"train_step": int(state.step), "dense_params": state.dense.jax_params(),
           "dense_opt": {"step": int(state.dense_opt.step),
                         "mu": _dcn_tree(cfg, state.dense_opt.mu),
                         "nu": _dcn_tree(cfg, state.dense_opt.nu)}}
    if isinstance(table, LPTTable):
        out.update(_lpt_to_numpy(table))
    else:
        out["emb_state"] = emb_state_to_numpy(table)
    if state.emb_opt is not None:
        params = get_method(cfg.spec.method).trainable_params(table, cfg.spec)
        out["emb_opt"] = {"step": int(state.emb_opt.step),
                          **{k: tree_like(params, [t.detach().cpu().numpy() for t in v])
                             for k, v in (("mu", state.emb_opt.mu), ("nu", state.emb_opt.nu))}}
    return out


def lm_params_from_numpy(cfg: tfm.ModelConfig, tree: dict, *,
                         device: str | torch.device = "cuda") -> dict:
    """The reference's LM params (``transformer.init_params`` with numpy
    leaves: ``blocks`` a list per period position, each leaf stacked
    ``[n_groups, ...]``; weights ``[in, out]``) as the port's fp32 params."""
    dev = device_mod.resolve(device)
    tfm.check_supported(cfg)
    if len(tree["blocks"]) != cfg.period:
        raise ValueError(f"{len(tree['blocks'])} block positions != period {cfg.period}")

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [convert(v) for v in x]
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    params = convert(tree)
    for block in params["blocks"]:
        leaves = [block["attn"]["wq"], block["norm1"]]
        if any(t.shape[0] != cfg.n_groups for t in leaves):
            raise ValueError(f"block leaves must be stacked over {cfg.n_groups} groups")
    if cfg.tie_embeddings == ("head" in params):
        raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} but the params "
                         f"{'hold' if 'head' in params else 'lack'} a head")
    return params


def quant_table_from_numpy(spec: EmbeddingSpec, *, codes: np.ndarray, step: np.ndarray,
                           device: str | torch.device = "cuda") -> QuantTable:
    """The reference's int8-resident serving table (its ``QuantTable`` codes
    container bytes, int8 or packed, and Delta) as the port's."""
    dev = device_mod.resolve(device)
    store, step_t = _codes_and_step(spec, codes, step, dev)
    return QuantTable(codes=store, step=step_t, n=spec.n, d=spec.d,
                      use_kernels=spec.use_kernels)


def _opt_from_numpy(opt: dict | None, like: list, convert) -> OptState:
    """``{"step", "mu", "nu"}`` (reference ``OptState`` leaves as numpy) as the
    port's ``OptState`` over the tensors ``like``; zeros when ``opt`` is None."""
    if opt is None:
        return adam_init(like)
    return OptState(step=int(opt["step"]), mu=convert(opt["mu"]), nu=convert(opt["nu"]))


def lm_state_from_numpy(cfg: tfm.ModelConfig, tcfg: lm_trainer.LMTrainerConfig | None = None, *,
                        params: dict, table, opt: dict | None = None,
                        table_opt: dict | None = None, step: int = 0, seed: int = 0,
                        device: str | torch.device = "cuda") -> lm_trainer.LMTrainState:
    """A port ``LMTrainState`` for the reference's.

    ``params`` is the reference's param tree with numpy leaves; ``opt`` its
    Adam ``OptState`` as ``{"step", "mu", "nu"}`` with ``mu`` / ``nu`` trees
    laid out as ``params``.  ``table`` is, for lpt / alpt, ``{"codes",
    "step", "mu", "nu", "count"}`` (``codes`` the ``CodeStore.data`` bytes,
    int8 or packed uint8), for fp the [V, d] array, with ``table_opt`` its
    Adam state (``mu`` / ``nu`` arrays).  Missing optimizer states load as
    zeros.  The SR noise generator is seeded with ``seed``.
    """
    dev = device_mod.resolve(device)
    spec = lm_trainer.embedding_spec_of(cfg, tcfg)

    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    def tree(t):
        return tree_leaves(lm_params_from_numpy(cfg, t, device=dev))

    p = lm_params_from_numpy(cfg, params, device=dev)
    t_opt = None
    if spec.is_integer_table:
        store, step_t = _codes_and_step(spec, table["codes"], table["step"], dev)
        tbl = LPTTable(codes=store, step=step_t, mu=tensor(table["mu"]), nu=tensor(table["nu"]),
                       count=int(table["count"]))
    else:
        tbl = tensor(table)
        t_opt = _opt_from_numpy(table_opt, [tbl], lambda a: [tensor(a)])
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    return lm_trainer.LMTrainState(params=p, opt=_opt_from_numpy(opt, tree_leaves(p), tree),
                                   table=tbl, table_opt=t_opt, step=int(step),
                                   generator=generator)


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
        table = {"codes": cpu(table.codes.data), "step": cpu(table.step), "mu": cpu(table.mu),
                 "nu": cpu(table.nu), "count": int(table.count)}
    else:
        table = cpu(table)
    return {"params": cpu(state.params),
            "opt": opt(state.opt, lambda leaves: tree_like(state.params, leaves)),
            "table": table, "table_opt": table_opt, "step": int(state.step)}
