"""Sharding policies and partition-spec builders for every trainer tree (port
of repro/dist/sharding.py), and the explicit shards they describe.

A :class:`Policy` names the parallelism style (tp / fsdp_tp / dp / *_sp /
*_ep) and carries the mesh-shape facts the spec builders need.  The builders
return spec trees that mirror the port's trees (params, optimizer state,
quantized tables, batches, decode caches), with divisibility-guarded
placement: an axis that does not evenly divide a dimension is dropped, so
degenerate shapes (hubert's vocab=504 head on a 16-way model axis, odd head
counts, tiny smoke configs) degrade to replication.  The builders are pure
functions of shapes and equal the reference's entry for entry.

Layout rules (Megatron-style), the reference's:

* attention / MLP in-projections are column-parallel (output dim over
  'model'), out-projections row-parallel (input dim over 'model');
* MoE expert stacks shard the expert dim over 'model';
* the quantized vocab table (codes, Delta, row-Adam slots) shards vocab over
  'model', falling back to the feature dim when vocab does not divide;
* fsdp_* also shards the non-model matrix dim over the data axes;
* dp replicates parameters and uses the model axis as extra data
  parallelism, while still sharding optimizer moments over 'model'.

A spec is :class:`P`, a tuple of mesh-axis entries (an axis name, a tuple
of names, or None per dimension).  Shapes come from ``torch.device("meta")``
(no memory), where the reference traces ``jax.eval_shape``.  GSPMD places
the reference's arrays; the port holds explicit per-rank shards instead:
:func:`shard_tree` cuts a rank's contiguous block of every leaf from the
whole tree, :func:`gather_tree` puts the whole leaves back together on
every rank of a model group (the checkpoint path).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


class P(tuple):
    """A partition spec: one mesh-axis entry per dimension (an axis name, a
    tuple of names, or None), printed as the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


# ------------------------------------------------------------------- policy


@dataclasses.dataclass(frozen=True)
class Policy:
    """Parallelism policy: axis names + shape facts + feature flags."""

    name: str
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    model_size: int = 1
    # Total data-parallel way-count (product over data_axes); None = unknown,
    # which disables fsdp placement (it cannot be divisibility-checked).
    data_size: int | None = None
    fsdp: bool = False
    seq_parallel: bool = False
    ep: bool = False  # explicit expert-parallel MoE dispatch
    pure_dp: bool = False  # model axis reused as extra data parallelism

    @property
    def dp_spec(self):
        """Spec entry for a batch dimension."""
        axes = tuple(self.data_axes)
        if self.pure_dp:
            axes = axes + (self.model_axis,)
        return axes[0] if len(axes) == 1 else axes


def policy_from_name(name: str, *, data_axes: tuple[str, ...] = ("data",), model_size: int = 1,
                     data_size: int | None = None) -> Policy:
    parts = name.split("_")
    return Policy(name=name, data_axes=data_axes, model_size=model_size, data_size=data_size,
                  fsdp="fsdp" in parts, seq_parallel="sp" in parts, ep="ep" in parts,
                  pure_dp=name == "dp")


# MoE archs get explicit EP dispatch; other multi-billion-param archs fsdp_tp.
_EP_ARCHS = frozenset({"mixtral-8x7b", "deepseek-moe-16b", "jamba-v0.1-52b"})
_FSDP_ARCHS = frozenset({"deepseek-67b", "qwen2-vl-7b"})


def default_policy(arch: str, *, multi_pod: bool = False, model_size: int = 16,
                   override: str | None = None, data_size: int | None = None) -> Policy:
    name = override
    if name is None:
        if arch in _EP_ARCHS:
            name = "fsdp_tp_ep"
        elif arch in _FSDP_ARCHS:
            name = "fsdp_tp"
        else:
            name = "tp"
    data_axes = ("pod", "data") if multi_pod else ("data",)
    if data_size is None:
        # The reference's production meshes are 16-way data per pod.
        data_size = 32 if multi_pod else 16
    return policy_from_name(name, data_axes=data_axes, model_size=model_size,
                            data_size=data_size)


# ------------------------------------------------------------- leaf placing


def _leaf_spec(shape, placements: dict[int, str], pol: Policy) -> P:
    """A spec from wanted ``{dim (may be negative): 'model'|'fsdp'}``, dropping
    any placement whose axis size does not divide the dimension (or is
    unknown / 1)."""
    entries: list[Any] = [None] * len(shape)
    for idx, which in placements.items():
        i = idx % len(shape) if shape else 0
        if which == "model":
            names: Any = pol.model_axis
            size = pol.model_size
        else:  # fsdp over the data axes
            if not pol.fsdp or not pol.data_size:
                continue
            axes = tuple(pol.data_axes)
            names = axes[0] if len(axes) == 1 else axes
            size = pol.data_size
        if size and size > 1 and shape[i] % size == 0:
            entries[i] = names
    return P(*entries)


# Column-parallel (output dim over 'model', optional fsdp on the input dim).
_COL_PARALLEL = frozenset({"wq", "wk", "wv", "w_gate", "w_up", "w_in", "wz", "wx", "wdt"})
# Row-parallel (input dim over 'model', optional fsdp on the output dim).
_ROW_PARALLEL = frozenset({"wo", "w_down", "w_out", "out_proj"})
# Vectors / conv stacks living in the model-sharded inner dimension.
_MODEL_LAST = frozenset({"bq", "bk", "bv", "b_in", "conv_x", "conv_bx", "norm_w", "dt_bias",
                         "A_log", "D"})


def _param_placements(path_names: tuple[str, ...]) -> dict[int, str]:
    name = path_names[-1]
    if "moe" in path_names:
        if "shared" in path_names or name == "router":
            return {}
        if name in ("w_gate", "w_up", "w_down"):
            return {-3: "model"}  # [..., E, d, f] / [..., E, f, d]: expert dim
        return {}
    if name in _COL_PARALLEL:
        return {-1: "model", -2: "fsdp"}
    if name in _ROW_PARALLEL:
        return {-2: "model", -1: "fsdp"}
    if name in _MODEL_LAST:
        return {-1: "model"}
    return {}  # norms, router, B/C streams, biases on d_model


def _head_spec(shape, pol: Policy) -> P:
    """Untied LM head [V, d]: vocab over 'model'; replicate the vocab dim and
    shard d instead when V does not divide (hubert's 504-way head on 16)."""
    v, d = shape
    m = pol.model_axis
    if pol.model_size > 1 and v % pol.model_size == 0:
        return P(m, None)
    if pol.model_size > 1 and d % pol.model_size == 0:
        return P(None, m)
    return P(None, None)


def _map_with_path(fn, tree, path=()):
    """``fn(path_names, leaf)`` over a nested dict / list tree (list indices
    as strings, the reference's key names)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _param_spec_tree(params_shapes, pol: Policy):
    def one(names, leaf):
        if names and names[-1] == "head":
            return _head_spec(leaf.shape, pol)
        if pol.pure_dp:
            return P()
        return _leaf_spec(tuple(leaf.shape), _param_placements(names), pol)

    return _map_with_path(one, params_shapes)


# --------------------------------------------------------------- public API


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta: the initializers draw onto it
    (shapes only, no memory)."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(cfg):
    """``transformer.init_params(cfg)``'s tree with meta tensors."""
    from repro_torch.models import transformer as tfm

    return tfm.init_params(_MetaGenerator(), cfg)


def param_pspecs(cfg, pol: Policy, param_shapes_=None):
    """Spec tree mirroring ``transformer.init_params(cfg)``."""
    return _param_spec_tree(param_shapes(cfg) if param_shapes_ is None else param_shapes_, pol)


def _table_axes(cfg, pol: Policy):
    """(row_entry, col_entry) for the [V, d] embedding table family."""
    m = pol.model_axis
    if pol.model_size > 1 and cfg.vocab_size % pol.model_size == 0:
        return m, None
    if pol.model_size > 1 and cfg.d_model % pol.model_size == 0:
        return None, m
    return None, None


def table_pspecs(cfg, pol: Policy, row_optimizer: str = "adam"):
    """Specs for the embedding table state, the registered method's
    ``table_pspec`` (codes + Delta + row-optimizer slots for integer tables,
    a plain [V, d] spec for fp)."""
    from repro_torch import methods

    row, col = _table_axes(cfg, pol)
    return methods.get(cfg.embedding_method).table_pspec(row, col, row_optimizer=row_optimizer)


def state_pspecs(cfg, pol: Policy, tcfg=None, param_shapes_=None):
    """Spec tree mirroring an LM training state as its checkpoint holds it
    (``lm_trainer.LMCheckpoint``: the reference's ``LMTrainState`` fields,
    ``opt`` / ``table_opt`` moments laid out as their params, ``generator``
    for ``rng``)."""
    from repro_torch import methods
    from repro_torch.optim import OptState
    from repro_torch.training import lm_trainer

    tcfg = lm_trainer.LMTrainerConfig() if tcfg is None else tcfg
    shapes = param_shapes(cfg) if param_shapes_ is None else param_shapes_
    params_spec = _param_spec_tree(shapes, pol)
    # Optimizer moments mirror the params; under pure dp they still shard over
    # the model axis (ZeRO-1-style optimizer-state sharding).
    opt_pol = dataclasses.replace(pol, pure_dp=False) if pol.pure_dp else pol
    moment_spec = _param_spec_tree(shapes, opt_pol)
    method = methods.get(cfg.embedding_method)
    param_spec = method.param_pspec(*_table_axes(cfg, pol))
    table_opt = None if param_spec is None else OptState(step=P(), mu=param_spec, nu=param_spec)
    return lm_trainer.LMCheckpoint(
        params=params_spec, opt=OptState(step=P(), mu=moment_spec, nu=moment_spec),
        table=table_pspecs(cfg, pol, tcfg.row_optimizer), table_opt=table_opt, step=P(),
        generator=P())


def mesh_axes_size(mesh, axes) -> int:
    shape = dict(mesh.shape)
    size = 1
    for a in axes:
        size *= int(shape.get(a, 1))
    return size


def _dp_or_none(pol: Policy, batch_dim: int, mesh):
    """The data-parallel entry for a concrete batch dim on ``mesh``, or None
    when the dp way-count does not divide it."""
    spec = pol.dp_spec
    axes = spec if isinstance(spec, tuple) else (spec,)
    size = mesh_axes_size(mesh, axes)
    if size <= 1 or batch_dim % size:
        return None
    return spec


def model_or_none(pol: Policy, dim: int, mesh):
    """The model-axis entry for ``dim`` on ``mesh``, or None when the axis is
    absent / trivial or does not divide it."""
    size = mesh_axes_size(mesh, (pol.model_axis,))
    if size <= 1 or dim % size:
        return None
    return pol.model_axis


def batch_pspecs(batch_shapes, cfg, pol: Policy, mesh):
    """Specs for a model-input batch dict: the batch dim over the data axes.
    ``positions`` may be [3, B, T] (M-RoPE streams lead), its batch dim axis
    1; every other input leads with the batch."""
    specs = {}
    for name, leaf in batch_shapes.items():
        shape = tuple(leaf.shape)
        if name == "positions" and len(shape) == 3:
            specs[name] = P(None, _dp_or_none(pol, shape[1], mesh), None)
        else:
            dp = _dp_or_none(pol, shape[0], mesh) if shape else None
            specs[name] = P(dp, *([None] * (len(shape) - 1)))
    return specs


def cache_pspecs(cfg, pol: Policy, batch: int, mesh):
    """Specs mirroring ``transformer.init_cache``: one entry per period
    position, each stacked [n_groups, batch, ...].  Held against the
    reference's; nothing executes them (no serving path takes a mesh)."""
    dp = _dp_or_none(pol, batch, mesh)

    def model_if(dim: int):
        if pol.model_size > 1 and dim % pol.model_size == 0:
            return pol.model_axis
        return None

    _, kv = cfg.padded_heads
    caches = []
    for pos in range(cfg.period):
        if cfg.layer_type(pos) == "attn":
            kv_spec = P(None, dp, None, model_if(kv), None)
            caches.append({"k": kv_spec, "v": kv_spec})
        else:
            s = cfg.ssm
            caches.append({
                "conv_x": P(None, dp, None, model_if(s.d_inner)),
                "conv_B": P(None, dp, None, None),
                "conv_C": P(None, dp, None, None),
                "ssm": P(None, dp, model_if(s.n_heads), None, None),
            })
    return caches


# ----------------------------------------------------------- explicit shards


def spec_leaves(tree) -> list:
    """The :class:`P` leaves of a spec tree, in ``optim.tree_leaves`` order
    (dict keys sorted, sequences and NamedTuples in order)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for x in tree for s in spec_leaves(x)]
    return [] if tree is None else [tree]


def is_sharded(spec: P, mesh) -> bool:
    """Whether ``spec`` places any dimension over a mesh axis of size > 1."""
    return any(_entry_size(e, mesh) > 1 for e in spec)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _entry_size(entry, mesh) -> int:
    return mesh_axes_size(mesh, _axes(entry))


def _entry_index(entry, mesh) -> int:
    """This rank's block index along ``entry``'s axes (row-major over them)."""
    idx = 0
    for a in _axes(entry):
        idx = idx * int(mesh.shape.get(a, 1)) + int(mesh.coords.get(a, 0))
    return idx


def _slice(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's contiguous block of ``t`` under ``spec`` (a copy)."""
    for dim, entry in enumerate(spec):
        size = _entry_size(entry, mesh)
        if size <= 1:
            continue
        n = t.shape[dim]
        if n % size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {size} ways")
        k = n // size
        t = t.narrow(dim, _entry_index(entry, mesh) * k, k)
    return t.clone()


def _gather(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block: all-gathered along each split
    dimension over its axis's group (the model group, or the data group for
    an fsdp block), in rank order."""
    for dim, entry in enumerate(spec):
        size = _entry_size(entry, mesh)
        if size <= 1:
            continue
        axes = tuple(a for a in _axes(entry) if int(mesh.shape.get(a, 1)) > 1)
        if len(axes) != 1:
            raise ValueError(f"a block over {entry!r} spans several axes of the mesh")
        # int8 codes and bool masks (prune's) travel as their bytes (gloo's
        # all_gather of uint8 on CUDA tensors is the probed one,
        # chip_smoke.gloo_probe).
        wire = (t.contiguous().view(torch.uint8) if t.dtype in (torch.int8, torch.bool)
                else t.contiguous())
        parts = [torch.empty_like(wire) for _ in range(size)]
        dist.all_gather(parts, wire, group=mesh.groups[axes[0]])
        t = torch.cat(parts, dim=dim).view(t.dtype)
    return t


def split_axes(spec: P, mesh) -> tuple[str, ...]:
    """The mesh axes of size > 1 that cut a leaf of ``spec``, in the mesh's
    order (``()`` for a replicated leaf)."""
    used = {a for e in spec for a in _axes(e) if int(mesh.shape.get(a, 1)) > 1}
    return tuple(a for a in mesh.axis_names if a in used)


def block_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """The shape of a rank's block of a leaf of the whole ``shape`` (a spec
    shorter than the shape replicates the dimensions it leaves out)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // _entry_size(e, mesh) for n, e in zip(shape, entries))


def fsdp_dim(name: str) -> int | None:
    """The dimension fsdp cuts over the data axes in a block's leaf
    ``name`` (an attention, dense MLP or mamba projection; never an
    expert's), or None."""
    return next((d for d, which in _param_placements((name,)).items() if which == "fsdp"), None)


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a state tree and its spec tree (NamedTuples,
    dicts and lists walked together; a spec of None keeps None)."""
    from repro_torch.core.codestore import CodeStore

    if isinstance(specs, P):
        if isinstance(tree, (CodeStore, torch.Tensor)):
            return fn(tree, specs)
        if isinstance(tree, dict):  # a restored code container: {"data": bytes}
            return {k: _map_specs(fn, v, specs) for k, v in tree.items()}
        return tree  # Python ints, a generator: replicated as they are
    if specs is None:
        return tree
    if hasattr(specs, "_fields") and isinstance(tree, dict):  # a restored tree
        return {k: _map_specs(fn, v, getattr(specs, k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, a, b) for a, b in zip(tree, specs, strict=True)))
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, a, b) for a, b in zip(tree, specs, strict=True))
    raise TypeError(f"no spec for a {type(tree).__name__}")


def _store_block(store, spec: P, mesh, fn):
    """A code container's block: its bytes cut (or gathered) by ``fn``, its
    logical width recomputed.  A packed container holds ``8 // bits`` codes
    a byte, so a block of whole bytes is a block of codes."""
    data = fn(store.data, spec, mesh)
    d = store.d * data.shape[1] // store.data.shape[1]
    if store.packed and d * store.bits != data.shape[1] * 8:
        raise ValueError(f"a {store.bits}-bit packed block of {tuple(data.shape)} bytes "
                         f"splits a row of {store.d} codes off a byte boundary")
    return dataclasses.replace(store, data=data, n=int(data.shape[0]), d=int(d))


def shard_tree(tree, specs, mesh):
    """This rank's shards of a whole tree: each tensor's contiguous block
    under its spec (copies, so the whole leaves can be freed), a code
    container cut along its rows or bytes, Python scalars and generators as
    they are."""
    from repro_torch.core.codestore import CodeStore

    def one(leaf, spec):
        if isinstance(leaf, CodeStore):
            return _store_block(leaf, spec, mesh, _slice)
        return _slice(leaf, spec, mesh)

    return _map_specs(one, tree, specs)


def gather_tree(tree, specs, mesh):
    """The whole tree from every rank's shards (a collective: every rank
    of the mesh calls it); the inverse of :func:`shard_tree`."""
    from repro_torch.core.codestore import CodeStore

    def one(leaf, spec):
        if isinstance(leaf, CodeStore):
            return _store_block(leaf, spec, mesh, _gather)
        return _gather(leaf, spec, mesh)

    return _map_specs(one, tree, specs)
