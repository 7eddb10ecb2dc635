"""LM training step with a registry-dispatched vocab embedding table (port of
repro/training/lm_trainer.py, the single-program path).

The embedding method comes from ``repro_torch.methods``
(``cfg.embedding_method``); each step:

  1. materialize the method's dense differentiable params (for integer
     tables: the de-quantized [V, d] table),
  2. differentiate the LM loss w.r.t. (those params, the transformer params),
  3. clip the transformer's gradients by their global norm and AdamW them
     (one ``adam_update`` kernel launch on the card); the method's
     ``dense_update`` consumes the table gradient (LPT: the row update and
     the ``lpt_fused_update`` write-back; ALPT: the float update, then
  4. Delta learned through the second fake-quant forward at the updated
     params, and the ``sr_round`` write-back).  Untouched rows stay
     bit-identical.

The SR noise of a step is drawn from the state's ``torch.Generator`` on its
device; :func:`make_train_step`'s ``noise`` operand lets a parity test pass
the reference's draw instead (``quant.sr_noise(kn, (n, d))`` for LPT,
``sr_noise(fold_in(kn, 1), (n, d))`` for ALPT).  :func:`make_train_step`'s
``grad_sync`` / ``step_grad_sync`` / ``dp_size`` are the data-parallel hooks
(:mod:`repro_torch.training.data_parallel` fills them; ``dp_sync_bits`` is
the sync width).  :func:`wrap_host_refresh` wraps a step with prune's
host-side mask refresh (``LMTrainerConfig.prune`` is its schedule);
``LMTrainerConfig.pad_to_tiles`` allocates the table at the reference's
padded geometry.  ``LMTrainerConfig.guard`` wraps the step in the
non-finite guard (:func:`repro_torch.faults.wrap_lm_step`, inside the prune
refresh as in the reference): a step whose loss or params come out
non-finite returns the state before it, its step counter and generator
advanced; it hosts the ``trainer.nonfinite`` and ``alpt.delta`` seams of
the plan installed when the step is made.  The reference's ``alpt_every``
is not ported: no path reads it.  :func:`save` / :func:`restore`
checkpoint a state (``repro_torch.checkpoint``).

The sharded path (port of the reference's GSPMD step): under
``repro_torch.dist.context.use(mesh, policy)`` (a ``(data, model)`` rank
grid, :mod:`repro_torch.launch.mesh`; any of the reference's policies:
``tp``, ``tp_sp``, ``tp_ep``, ``tp_sp_ep``, ``fsdp_tp``, ``fsdp_tp_sp``,
``fsdp_tp_ep``, ``dp``), :func:`init_state` gives this rank's shard of the
one-process init (every leaf the slice of the one-process draw,
:func:`state_specs`), and
:func:`make_train_step` a step over shards: the batch's slice over the
data axis (``batch_pspecs``; a batch the axis does not divide is
replicated), the model's collectives at the reference's hint sites
(:mod:`repro_torch.dist.tensor_parallel`), the data-axis gradient mean
through ``collectives.exact_pmean_local``, the global norm over the whole
tree, and the table's write-back on this rank's rows (its SR noise the
rows' slice of the one-process draw, so codes compare across meshes).
:func:`save` gathers the shards and rank 0 writes the reference's layout
(whole leaves); :func:`restore` hands each rank its shard for the mesh it
runs on.  Mamba mixers run their heads' shards; an attention or SSD
shard that splits a head is gathered and run replicated; a padded table
splits its allocated rows (the scratch row lands on the rank whose block
holds it); the guard's verdict is the whole world's.  Every method runs
there: a table the method's specs keep whole (qr_lpt, qr_alpt, hash,
mixed) is a replica on every rank, stepped as the one process steps it; a
split table's replicated float leaf that reads only the rank's columns
(lsq's step size, pact's alpha) takes the ranks' summed gradient; prune's
mask refresh reads the whole table (:func:`wrap_host_refresh`).  Under a
``tp_ep`` policy the MoE layers take the explicit expert-parallel dispatch
(``models.moe.moe_forward_ep``); with ``sp`` the dispatch reads the whole
sequence, gathered before it and cut after.

fsdp (``fsdp_tp``, ``fsdp_tp_sp``, ``fsdp_tp_ep``, with the policy's
``data_size`` the mesh's data axis): the projections' blocks over the
data axis are gathered where each sub-layer reads them and freed after
(``tp.fsdp_whole``; each group runs as with remat, so its backward gathers
them again), their gradients meaned over the data group in that gather's
backward, not again by the step; Adam steps each block with its
moments' blocks; the global norm sums each leaf's squares over exactly the
axes that cut it.  dp (``pure_dp``, the model axis more data parallelism):
the batch is cut over every rank, the blocks' params are whole, the vocab
table and the untied head (split over the model axis, as the reference's
specs keep them) enter whole (``tp.vocab_whole``), every gradient is the
exact mean over all the mesh's ranks, and each rank steps its model block
of every param with its moments' blocks (ZeRO-1), then all-gathers the new
params over the model group, so the replicas stay bitwise equal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch import faults, methods
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import alpt as alpt_core
from repro_torch.core import quant
from repro_torch.core.alpt import ALPTConfig
from repro_torch.core.codestore import CodeStore
from repro_torch.core.pruning import PruneConfig
from repro_torch.dist import collectives
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import sharding
from repro_torch.dist import tensor_parallel as tp
from repro_torch.methods import layout
from repro_torch.models import transformer as tfm
from repro_torch.optim import (OptState, adam_init, adam_update, clip_by_global_norm, tree_leaves,
                               tree_like)


class LMTrainState(NamedTuple):
    params: Any  # transformer blocks (+ untied head)
    opt: Any  # OptState over tree_leaves(params)
    table: Any  # embedding-method state (an LPTTable for lpt/alpt, f32 [V, d] for fp)
    table_opt: Any  # OptState over the float table (fp), else None
    step: int
    generator: torch.Generator  # SR noise, on the state's device


@dataclasses.dataclass(frozen=True)
class LMTrainerConfig:
    lr: float = 3e-4
    weight_decay: float = 0.01
    emb_weight_decay: float = 5e-8  # paper's embedding decay
    grad_clip: float = 1.0
    row_optimizer: str = "adam"
    alpt_step_lr: float = 2e-5
    # DeepLight schedule for method='prune' (host-side mask refresh).
    prune: PruneConfig = PruneConfig()
    # Gradient-sync width of data-parallel training
    # (repro_torch.training.data_parallel): 32 = exact fp32, 2..8 = SR codes.
    dp_sync_bits: int = 32
    # Route the integer table's write-back and the dense Adam through the
    # CUDA kernels; False asks for the plain versions on any device.
    use_kernels: bool = True
    # Pad the vocab table to the reference's tile geometry
    # (EmbeddingSpec.pad_to_tiles: a scratch row, rows and width rounded).
    pad_to_tiles: bool = False
    # The opt-in non-finite guard (repro_torch.faults.guards): skip a step
    # whose loss or params come out NaN / Inf.  Off: the step is untouched.
    guard: bool = False


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
        prune=tcfg.prune,
        use_kernels=tcfg.use_kernels,
        pad_to_tiles=tcfg.pad_to_tiles,
    )


# ------------------------------------------------------------- the shards


class Shards(NamedTuple):
    """The active context's layout of an LM state: the mesh and policy,
    the spec tree of :class:`LMTrainState` (:func:`state_specs`), this
    rank's table geometry (``spec``: its rows and columns), whether the
    table is split over d, the mesh axes that cut each transformer leaf
    (``sharding.split_axes``, in ``tree_leaves`` order), and the whole
    table's allocated shape."""

    mesh: Any
    policy: Any
    specs: Any
    spec: methods.EmbeddingSpec
    width_split: bool
    split_axes: list
    table_shape: tuple

    @property
    def premeaned(self) -> list:
        """Per transformer leaf, whether the gather that brings it whole
        already took the batch's mean of its gradient (fsdp's blocks over
        the data axis; under dp the head's vocab blocks), so the step does
        not mean it again."""
        if self.policy.pure_dp:
            return [bool(axes) for axes in self.split_axes]
        return ["data" in axes for axes in self.split_axes]

    @property
    def table_premeaned(self) -> bool:
        """Whether the table's gradients come meaned over the batch's
        ranks: under dp a split table enters whole through
        ``tp.vocab_whole``, whose backward means."""
        return bool(self.policy.pure_dp and self.table_split)

    @property
    def table_split(self) -> bool:
        """Whether any leaf of the table's state is a block of the whole
        (False for a table every rank holds whole)."""
        return any(sharding.is_sharded(s, self.mesh)
                   for s in sharding.spec_leaves(self.specs.table))

    @property
    def partial_emb(self) -> list | None:
        """Per float leaf of the table (``trainable_params``' leaves), whether
        it is replicated over a table split over d, so that it reads only
        this rank's columns (lsq's step size, pact's alpha) and its gradient
        is the model ranks' sum; None for an integer table."""
        if self.specs.table_opt is None:
            return None
        return [self.width_split and not sharding.is_sharded(s, self.mesh)
                for s in self.specs.table_opt.mu]


def check_shardable(mesh, pol) -> None:
    """Raise ``ValueError`` for a policy whose shape facts are not this
    ``(data, model)`` mesh's: a ``model_size`` other than the model axis,
    or a ``data_size`` other than the data axis (None places nothing over
    the data axis, the reference's rule, so fsdp then cuts no block)."""
    m, d = int(mesh.shape["model"]), int(mesh.shape["data"])
    if pol.model_size != m:
        raise ValueError(f"policy model_size {pol.model_size} != the mesh's model axis {m}")
    if pol.data_size is not None and pol.data_size != d:
        raise ValueError(f"policy data_size {pol.data_size} != the mesh's data axis {d}")


def _allocated(spec: methods.EmbeddingSpec) -> tuple[int, int]:
    """The allocated [rows, width] of an fp / lpt / alpt table: an integer
    table's padded geometry, a float table's live one (fp pads nothing)."""
    if methods.get(spec.method).is_integer_table:
        return spec.n_padded, spec.d_padded
    return spec.n, spec.d


def _table_axes(cfg: tfm.ModelConfig, spec: methods.EmbeddingSpec, pol):
    """The table's (row, col) entries as the step executes them: the spec
    builders', dropped (the table replicated) where the method's specs keep
    the table whole (qr_*, hash, mixed: every leaf ``P()``) or where the
    allocated table does not split: a padded table (``pad_to_tiles``, its
    scratch row and tile rounding) whose padded rows or width the axis does
    not divide, or whose padded width is not its live width; packed codes
    whose d split would not fill whole bytes."""
    row, col = sharding._table_axes(cfg, pol)
    if not any(e is not None for s in sharding.spec_leaves(
            methods.get(spec.method).table_pspec(row, col)) for e in s):
        return None, None
    m = pol.model_size
    n, d = _allocated(spec)
    if (n, d) != (spec.n, spec.d) and (d != spec.d or (row and n % m) or (col and d % m)):
        return None, None
    if col is not None and spec.packed and spec.bits in (2, 4) and (
            cfg.d_model // m * spec.bits) % 8:
        return None, None
    return row, col


def state_specs(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig | None, mesh, pol) -> LMTrainState:
    """The spec tree of an :class:`LMTrainState` on ``mesh``: the
    reference's ``state_pspecs`` with the Adam moments as the state holds
    them (a list over ``tree_leaves(params)``)."""
    tcfg = LMTrainerConfig() if tcfg is None else tcfg
    spec = embedding_spec_of(cfg, tcfg)
    method = methods.get(spec.method)
    ck = sharding.state_pspecs(cfg, pol, tcfg)
    row, col = _table_axes(cfg, spec, pol)
    emb = method.param_pspec(row, col)

    def opt(mu, nu):
        return OptState(step=sharding.P(), mu=sharding.spec_leaves(mu),
                        nu=sharding.spec_leaves(nu))

    return LMTrainState(params=ck.params, opt=opt(ck.opt.mu, ck.opt.nu),
                        table=method.table_pspec(row, col, row_optimizer=tcfg.row_optimizer),
                        table_opt=None if emb is None else opt(emb, emb), step=sharding.P(),
                        generator=sharding.P())


def _shards(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig | None) -> Shards | None:
    """The active context's :class:`Shards` (None without a context or on a
    1 x 1 mesh), after :func:`check_shardable`."""
    ctx = dist_ctx.current()
    if ctx is None or ctx.mesh.size == 1:
        return None
    tcfg = LMTrainerConfig() if tcfg is None else tcfg
    mesh, pol = ctx.mesh, ctx.policy
    check_shardable(mesh, pol)
    spec = embedding_spec_of(cfg, tcfg)
    specs = state_specs(cfg, tcfg, mesh, pol)
    row, col = _table_axes(cfg, spec, pol)
    m = int(mesh.shape["model"])
    local = spec
    if row or col:  # this rank's block of the allocated table (a padded one's scratch row too)
        n, d = _allocated(spec)
        local = dataclasses.replace(spec, n=n // m if row else n, d=d // m if col else d,
                                    pad_to_tiles=False)
    axes = [sharding.split_axes(p, mesh) for p in sharding.spec_leaves(specs.params)]
    return Shards(mesh=mesh, policy=pol, specs=specs, spec=local, width_split=col is not None,
                  split_axes=axes, table_shape=(spec.n_padded, spec.d_padded))


def init_state(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig | None = None, *, seed: int = 0,
               device: str | torch.device = "cuda", optimizer: bool = True) -> LMTrainState:
    """Params, then the vocab table, drawn from one generator seeded with
    ``seed`` on ``device`` (``cuda`` unless the caller asks for the CPU;
    raises if CUDA is asked for and absent), which then draws the SR noise.
    The draws are torch's: a parity test carries the reference's state
    across through ``repro_torch.interop``.  ``optimizer=False`` leaves
    ``opt`` and ``table_opt`` None (the same draws): a state to serve, which
    at qwen2-vl-7b's full depth is 28 GB of params without 57 GB of Adam
    moments.  Under a sharding context (:func:`state_specs`), this rank's
    shard of that state (the whole draws made, sliced, then freed; the
    moments zeros of their own blocks, which under dp are blocks of whole
    params)."""
    dev = device_mod.resolve(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    params = tfm.init_params(generator, cfg)
    spec = embedding_spec_of(cfg, tcfg)
    method = methods.get(spec.method)
    table = method.init(generator, spec)
    sh = _shards(cfg, tcfg)
    opt = None
    if optimizer:  # zeros shaped as the moments' blocks (under dp, blocks of whole params)
        opt = adam_init(tree_leaves(params) if sh is None else [
            torch.empty(sharding.block_shape(p.shape, s, sh.mesh), device=dev)
            for p, s in zip(tree_leaves(params), sh.specs.opt.mu, strict=True)])
    if sh is not None:  # this rank's slice of the one-process draws
        params = sharding.shard_tree(params, sh.specs.params, sh.mesh)
        table = sharding.shard_tree(table, sh.specs.table, sh.mesh)
        spec = sh.spec
    emb = method.trainable_params(table, spec)
    return LMTrainState(params=params, opt=opt,
                        table=table,
                        table_opt=None if emb is None or not optimizer else adam_init(
                            tree_leaves(emb)),
                        step=0, generator=generator)


def clone_state(state: LMTrainState) -> LMTrainState:
    """A deep copy, the generator's state included (to replay steps)."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, CodeStore):
            return dataclasses.replace(x, data=x.data.clone())
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, list):
            return [copy(v) for v in x]
        if isinstance(x, tuple) and hasattr(x, "_fields"):  # OptState, LPTTable, ...
            return type(x)(*(copy(v) for v in x))
        if isinstance(x, tuple):  # mixed's tuple of sub-tables
            return tuple(copy(v) for v in x)
        return x

    generator = torch.Generator(device=state.generator.device)
    generator.set_state(state.generator.get_state())
    return copy(state._replace(generator=None))._replace(generator=generator)


class LMCheckpoint(NamedTuple):
    """An LM training state as a checkpoint tree: the reference's
    ``LMTrainState`` fields, the generator's state for its ``rng``."""

    params: Any
    opt: Any
    table: Any
    table_opt: Any
    step: Any
    generator: Any


def checkpoint_tree(cfg: tfm.ModelConfig, state: LMTrainState,
                    tcfg: LMTrainerConfig | None = None) -> LMCheckpoint:
    """The checkpoint tree of an LM training state (the reference's
    ``LMTrainState`` leaves, the generator's state for ``rng``); leaves are
    the state's own tensors."""
    spec = embedding_spec_of(cfg, tcfg)
    params = methods.get(spec.method).trainable_params(state.table, spec)
    return LMCheckpoint(params=state.params, opt=ckpt.opt_tree(state.opt, state.params),
                        table=state.table, table_opt=ckpt.opt_tree(state.table_opt, params),
                        step=state.step, generator=state.generator.get_state())


def state_from_checkpoint(cfg: tfm.ModelConfig, tree, tcfg: LMTrainerConfig | None = None, *,
                          seed: int = 0, device: str | torch.device = "cuda",
                          spec: methods.EmbeddingSpec | None = None) -> LMTrainState:
    """The ``LMTrainState`` of a restored checkpoint tree (port or
    reference: the reference's param tree, its ``OptState`` with ``mu`` /
    ``nu`` laid out as the params, the table in ``methods.layout``'s layout
    with a float-leaf method's ``table_opt``), its leaves on ``device``; a
    missing optimizer state loads as zeros.  A reference checkpoint's
    generator is seeded with ``checkpoint.manager.reference_generator_seed``
    of ``seed`` and the step.  ``spec``: the table's geometry when the tree
    holds this rank's shards (:class:`Shards`)."""
    dev = device_mod.resolve(device)
    spec = embedding_spec_of(cfg, tcfg) if spec is None else spec

    def param_moments(t):
        return tree_leaves(tfm.params_from_numpy(cfg, t, device=dev))

    params = tfm.params_from_numpy(cfg, tree["params"], device=dev)
    table = layout.emb_state_from_numpy(spec, tree["table"], device=dev)
    emb = methods.get(spec.method).trainable_params(table, spec)
    step = int(tree["step"])
    return LMTrainState(
        params=params, opt=ckpt.opt_from_tree(tree.get("opt"), tree_leaves(params), param_moments),
        table=table, table_opt=None if emb is None else ckpt.opt_from_tree(
            tree.get("table_opt"), tree_leaves(emb), lambda t: ckpt.float_leaves(t, dev)),
        step=step, generator=ckpt.generator_from_tree(tree, seed, step, dev))


def save(manager: ckpt.CheckpointManager, cfg: tfm.ModelConfig, state: LMTrainState,
         tcfg: LMTrainerConfig | None = None, *, force: bool = False) -> bool:
    """Checkpoint ``state`` at its step through ``manager`` when its cadence
    says so, or when ``force``d: the reference's ``LMTrainState`` leaves
    (:func:`checkpoint_tree`), the generator's state, and a manifest with
    the config's hash and the embedding metadata.  Returns whether it
    saved.  Under a sharding context every rank calls it: the shards are
    gathered over the model group (a collective, when the cadence says so)
    and rank 0 writes the whole leaves, the reference's layout."""
    sh = _shards(cfg, tcfg)
    if sh is not None:
        if not (force or manager.should_save(state.step)):
            return False
        state = sharding.gather_tree(state, sh.specs, sh.mesh)
        if sh.mesh.rank != 0:
            return True
        force = True
    meta = {"config_hash": ckpt.config_hash(cfg),
            **ckpt.embedding_manifest(embedding_spec_of(cfg, tcfg))}
    return manager.maybe_save(checkpoint_tree(cfg, state, tcfg), state.step,
                              force=force, extra_meta=meta)


def restore(manager: ckpt.CheckpointManager, cfg: tfm.ModelConfig,
            tcfg: LMTrainerConfig | None = None, *, step: int | None = None,
            device: str | torch.device = "cuda") -> LMTrainState:
    """The state of ``step`` (default: the newest committed checkpoint that
    passes verification) on ``device``; a reference checkpoint loads too
    (:func:`state_from_checkpoint`, its generator seeded from
    :func:`init_state`'s default seed and the step).  Another config's
    table (method, schema, bits or packing in the manifest, or the leaves
    themselves) raises ``ValueError``.  Under a sharding context each rank
    gets its shard for the mesh it runs on, whatever mesh saved it."""
    dev = device_mod.resolve(device)
    spec = embedding_spec_of(cfg, tcfg)
    sh = _shards(cfg, tcfg)
    shardings = None if sh is None else (_checkpoint_specs(cfg, tcfg, sh), sh.mesh)
    tree, _ = manager.restore(step=step, device=dev, spec=spec, shardings=shardings)
    local = spec if sh is None else sh.spec
    ckpt.check_table(tree["table"], local)
    return state_from_checkpoint(cfg, tree, tcfg, device=dev, spec=local)


def _checkpoint_specs(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig | None,
                      sh: Shards) -> LMCheckpoint:
    """:class:`Shards`' spec tree laid out as a checkpoint tree (moments as
    their params)."""
    spec = embedding_spec_of(cfg, tcfg)
    emb = methods.get(spec.method).param_pspec(*_table_axes(cfg, spec, sh.policy))
    moments = sharding.state_pspecs(cfg, sh.policy, tcfg).opt.mu  # laid out as the params
    return LMCheckpoint(params=sh.specs.params,
                        opt=OptState(step=sharding.P(), mu=moments, nu=moments),
                        table=sh.specs.table,
                        table_opt=None if emb is None else OptState(step=sharding.P(), mu=emb,
                                                                    nu=emb),
                        step=sharding.P(), generator=sharding.P())


def table_fp_of(state: LMTrainState, cfg: tfm.ModelConfig,
                tcfg: LMTrainerConfig | None = None) -> torch.Tensor:
    """The [V, d] float table evaluation forwards read."""
    spec = embedding_spec_of(cfg, tcfg)
    return methods.get(spec.method).eval_table(state.table, spec)


def make_grad_fn(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig,
                 spec: methods.EmbeddingSpec | None = None, partial: list | None = None):
    """One backward: ``(state, batch) -> ((loss, aux), (g_emb, g_params))``,
    ``g_emb`` shaped as the method's ``dense_params`` (for integer tables the
    de-quantized [V, d] table) and ``g_params`` a list in
    ``tree_leaves(state.params)`` order.  A leaf the loss does not read has
    a zero gradient, as ``jax.grad`` gives: the table of an ``embeds``
    config with an untied head (the encoder), which then steps as the
    reference's does, by its optimizer's decay and Delta's own step.
    ``spec``: the table's geometry when it is a shard (:class:`Shards`);
    ``partial``: its float leaves that take the model ranks' summed
    gradient (:attr:`Shards.partial_emb`)."""
    spec = embedding_spec_of(cfg, tcfg) if spec is None else spec
    method = methods.get(spec.method)

    def grad_fn(state: LMTrainState, batch: dict):
        dense = method.dense_params(state.table, spec)
        emb = [t.detach().requires_grad_(True) for t in tree_leaves(dense)]
        read = emb if partial is None else [tp.partial_weight(t, p)
                                            for t, p in zip(emb, partial, strict=True)]
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
        params = tree_like(state.params, leaves)
        with torch.enable_grad():
            table_fp = method.dense_table_from(state.table, tree_like(dense, read), spec)
            loss, aux = tfm.loss_fn(params, table_fp, batch, cfg)
            grads = alpt_core.grads_or_zeros(loss, [*emb, *leaves])
        g_emb = tree_like(dense, list(grads[: len(emb)]))
        return (loss.detach(), aux.detach()), (g_emb, list(grads[len(emb):]))

    return grad_fn


def make_delta_grad_fn(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig,
                       spec: methods.EmbeddingSpec | None = None):
    """ALPT's Delta gradient: ``(w_new, step_vec, params, batch, gscale) -> g_step``."""
    spec = embedding_spec_of(cfg, tcfg) if spec is None else spec
    method = methods.get(spec.method)

    def delta_fn(w_new, step_vec, params, batch, gscale):
        return method.dense_delta_grad(
            w_new, step_vec, lambda t: tfm.loss_fn(params, t, batch, cfg)[0],
            spec=spec, weight_decay=tcfg.emb_weight_decay, gscale=gscale)

    return delta_fn


def make_apply_fn(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig, *, donate: bool = False,
                  shards: Shards | None = None):
    """The update: ``apply_fn(state, loss_aux, grads, *, lr, noise,
    delta_grad=None, batch_rows=None) -> (state, metrics)``.

    ``delta_grad(w_new, step_vec, new_params, gscale) -> g_step`` supplies
    ALPT's Delta gradient at the updated params; ``batch_rows`` is the
    paper's b, the batch's token count.  ``donate`` (the reference's CLI
    jits its step with ``donate_argnums=(0,)``): the step consumes
    ``state`` and ``grads``, clipping the gradients and stepping the params
    and their Adam moments in place (bitwise the same values), so the old
    and new params and moments are not alive together.  ``shards``: the
    state is this rank's (:class:`Shards`); the global norm sums each
    leaf's squares over the group of the axes that cut it; under dp each
    rank steps its moments' block of a whole param and the new blocks are
    all-gathered over the model group (:func:`_zero1_adam`)."""
    spec = embedding_spec_of(cfg, tcfg) if shards is None else shards.spec
    method = methods.get(spec.method)
    clip = {}
    if shards is not None:
        mesh = shards.mesh
        clip = {"split": shards.split_axes,
                "groups": {("model",): mesh.groups["model"], ("data",): mesh.groups["data"],
                           ("data", "model"): dist.group.WORLD}}
    zero1 = shards is not None and shards.policy.pure_dp and shards.mesh.shape["model"] > 1

    def apply_fn(state: LMTrainState, loss_aux, grads, *, lr, noise, delta_grad=None,
                 batch_rows=None):
        loss, aux = loss_aux
        g_table, g_params = grads
        g_params, gnorm = clip_by_global_norm(g_params, tcfg.grad_clip, inplace=donate, **clip)
        if zero1:
            new_leaves, new_opt = _zero1_adam(g_params, state, lr, tcfg, shards)
        else:
            new_leaves, new_opt = adam_update(g_params, state.opt, tree_leaves(state.params), lr,
                                              weight_decay=tcfg.weight_decay,
                                              use_kernel=tcfg.use_kernels, inplace=donate)
        new_params = tree_like(state.params, new_leaves)
        wrapped = None
        if delta_grad is not None:
            def wrapped(w_new, step_vec, gscale):  # Algorithm 1 line 4: UPDATED params
                return delta_grad(w_new, step_vec, new_params, gscale)

        new_table, new_table_opt, emb_aux = method.dense_update(
            state.table, state.table_opt, g_table, spec=spec, lr=lr,
            weight_decay=tcfg.emb_weight_decay, noise=noise, delta_grad=wrapped,
            batch_rows=batch_rows)
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": gnorm, "lr": lr, **emb_aux}
        return LMTrainState(params=new_params, opt=new_opt, table=new_table,
                            table_opt=new_table_opt, step=state.step + 1,
                            generator=state.generator), metrics

    return apply_fn


def _zero1_adam(grads: list, state: LMTrainState, lr: float, tcfg: LMTrainerConfig,
                sh: Shards):
    """dp's AdamW (the reference's ZeRO-1 layout, ``state_pspecs``' moments
    over the model axis): each param the moments cut from a whole param is
    stepped on this rank's block of it, the rest as they are, in one
    ``adam_update``; the new blocks are all-gathered over the model group
    into whole params, the same on every rank."""
    mesh = sh.mesh
    params = tree_leaves(state.params)
    cut = [sharding.is_sharded(m, mesh) and not axes
           for m, axes in zip(sh.specs.opt.mu, sh.split_axes, strict=True)]
    blocks = [sharding.shard_tree(t, m, mesh) if c else t
              for t, m, c in zip(params, sh.specs.opt.mu, cut)]
    grads = [sharding.shard_tree(g, m, mesh) if c else g
             for g, m, c in zip(grads, sh.specs.opt.mu, cut)]
    new, opt = adam_update(grads, state.opt, blocks, lr, weight_decay=tcfg.weight_decay,
                           use_kernel=tcfg.use_kernels)
    return [sharding.gather_tree(t, m, mesh) if c else t
            for t, m, c in zip(new, sh.specs.opt.mu, cut)], opt


def make_lr_fn(tcfg: LMTrainerConfig, lr_schedule=None):
    """``lr_at(step) -> float``: ``lr_schedule(step)`` of the host step (a
    :mod:`repro_torch.optim.schedule`), or the constant ``tcfg.lr`` without
    one, rounded to float32 as the reference holds it."""
    def lr_at(step: int) -> float:
        return float(np.float32(tcfg.lr if lr_schedule is None else lr_schedule(step)))

    return lr_at


def check_trainable(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig) -> None:
    """Raise for a model the LM trainer cannot train yet."""
    tfm.check_supported(cfg)


def make_train_step(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig, lr_schedule=None, *,
                    grad_sync=None, step_grad_sync=None, dp_size: int = 1,
                    donate: bool = False):
    """``train_step(state, batch, noise=None) -> (state, metrics)``; the
    step's ``lr`` is ``lr_schedule`` of ``state.step`` (:func:`make_lr_fn`).

    ``batch`` holds int32 ``tokens`` and ``labels`` [B, T] on the state's
    device; a ``mixed``-input config's also ``prefix_embeds`` [B, P, d] and,
    optionally, M-RoPE ``positions`` [3, B, T] (default: three equal
    streams), which the backward and ALPT's Delta recompute both read; an
    ``embeds`` config's (the encoder) ``embeds`` [B, T, d] in place of
    ``tokens``.  ``noise`` f32 [n, d] (the table's allocated shape; a composed
    table's, one per sub-table) is the SR draw of the write-back; by default
    it comes from ``state.generator`` (``method.dense_noise``).

    ``grad_sync(grads, step) -> grads`` and ``step_grad_sync(g_step, step)
    -> g_step`` are the data-parallel all-reduces (identity when None),
    applied between backward and update and to ALPT's Delta gradient.
    ``dp_size`` is the number of ranks, so that the paper's b (the Delta
    gradient's scale) counts the GLOBAL batch's token lookups.

    ``donate`` (:func:`make_apply_fn`): the step steps the params and their
    Adam moments in place, and the caller must not read the state it passed
    in; it spares a full copy of them, which is what lets deepseek-67b's
    full-width head and a layer train on one card.  The guard keeps the old
    state to roll back to, so ``tcfg.guard`` refuses it.

    Made under a sharding context (``dist.context.use``), the step runs on
    this rank's shards (:func:`_sharded_step`) and installs that context for
    each call, the guard's verdict one for the whole world group; the
    data-parallel hooks do not combine with it.
    """
    check_trainable(cfg, tcfg)
    if donate and tcfg.guard:
        raise ValueError("donate: the guard rolls back to the state before the step, which a "
                         "donated step overwrites")
    sh = _shards(cfg, tcfg)
    if sh is not None:
        if grad_sync is not None or step_grad_sync is not None:
            raise ValueError("the data-parallel hooks take a replicated state; a sharding "
                             "context syncs the data axis itself")
        step = _sharded_step(cfg, tcfg, sh, donate, lr_schedule)
        return faults.wrap_lm_step(step, group=dist.group.WORLD) if tcfg.guard else step
    spec = embedding_spec_of(cfg, tcfg)
    method = methods.get(spec.method)
    lr_at = make_lr_fn(tcfg, lr_schedule)
    grad_fn = make_grad_fn(cfg, tcfg)
    apply_fn = make_apply_fn(cfg, tcfg, donate=donate)
    delta_fn = make_delta_grad_fn(cfg, tcfg) if method.has_learned_step else None

    def train_step(state: LMTrainState, batch: dict, noise: torch.Tensor | None = None):
        if noise is None:
            noise = method.dense_noise(state.generator, state.table, spec)
        loss_aux, grads = grad_fn(state, batch)
        if grad_sync is not None:
            grads = grad_sync(grads, state.step)
        delta_grad = None
        if delta_fn is not None:
            def delta_grad(w_new, step_vec, new_params, gscale):
                g_step = delta_fn(w_new, step_vec, new_params, batch, gscale)
                if step_grad_sync is not None:
                    g_step = step_grad_sync(g_step, state.step)
                return g_step

        return apply_fn(state, loss_aux, grads, lr=lr_at(state.step), noise=noise,
                        delta_grad=delta_grad,
                        batch_rows=int(batch["labels"].numel()) * dp_size)

    if tcfg.guard:
        return faults.wrap_lm_step(train_step)
    return train_step


def _sharded_step(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig, sh: Shards, donate: bool,
                  lr_schedule=None):
    """The step over this rank's shards (``make_train_step`` under a
    context): ``train_step(state, batch, noise=None)`` on the GLOBAL batch.

    The batch follows ``batch_pspecs``: this rank's slice over the data axis,
    or the whole batch where the axis does not divide it.  ``noise`` is the
    one-process draw (the whole table's; a shard's shape is taken as it
    is), of which the step keeps this rank's rows; where the table is
    replicated (a model axis of 1) it is the method's one-process draw
    (``dense_noise``: a composed table's list), used as it is.  With a split batch, the
    gradients, ALPT's Delta gradient, the loss and the aux are exact
    rank-ordered means over the ranks that split it (the data group; under
    dp every rank, in the row-major order of the batch's cut), each leaf
    once: a gradient that a gather's backward has meaned
    (:attr:`Shards.premeaned`, :attr:`Shards.table_premeaned`) is not
    meaned again.  The paper's b counts the global batch's lookups; a table
    split over d scales it by the model axis, so that the gradient scale's
    b·d is the whole table's."""
    mesh, pol, spec = sh.mesh, sh.policy, sh.spec
    method = methods.get(spec.method)
    lr_at = make_lr_fn(tcfg, lr_schedule)
    grad_fn = make_grad_fn(cfg, tcfg, spec, sh.partial_emb)
    apply_fn = make_apply_fn(cfg, tcfg, donate=donate, shards=sh)
    delta_fn = make_delta_grad_fn(cfg, tcfg, spec) if method.has_learned_step else None
    group = None if pol.pure_dp else mesh.groups["data"]  # None: the world
    width = int(mesh.shape["model"]) if sh.width_split else 1
    table_split = sh.table_split
    skip_params, skip_table = sh.premeaned, sh.table_premeaned

    def train_step(state: LMTrainState, batch: dict, noise: torch.Tensor | None = None):
        bspecs = sharding.batch_pspecs(batch, cfg, pol, mesh)
        split = any(e is not None for b in bspecs.values() for e in b)
        layout = dist_ctx.StepLayout(width_split=sh.width_split, batch_split=split)
        with dist_ctx.use(mesh, pol, layout):
            if method.is_integer_table and not table_split:
                # The whole table on every rank: the one-process draw as it is.
                if noise is None:
                    noise = method.dense_noise(state.generator, state.table, spec)
            elif method.is_integer_table:  # one [V, d] table (lpt / alpt): this rank's rows
                if noise is None:
                    noise = quant.sr_noise(state.generator, sh.table_shape)
                if tuple(noise.shape) == sh.table_shape:
                    noise = sharding.shard_tree(noise, sh.specs.table.codes, mesh)
            local = sharding.shard_tree(batch, bspecs, mesh) if split else batch

            def mean(tree, skip):  # leaf by leaf (a composed table's are tuples)
                if not split:
                    return tree
                leaves = tree_leaves(tree)
                skip = [skip] * len(leaves) if isinstance(skip, bool) else skip
                return tree_like(tree, [t if s else collectives.exact_pmean_local(t, group)
                                        for t, s in zip(leaves, skip, strict=True)])

            (loss, aux), (g_table, g_params) = grad_fn(state, local)
            g_table, g_params = mean(g_table, skip_table), mean(g_params, skip_params)
            delta_grad = None
            if delta_fn is not None:
                def delta_grad(w_new, step_vec, new_params, gscale):
                    return mean(delta_fn(w_new, step_vec, new_params, local, gscale), skip_table)

            return apply_fn(state, (mean(loss, False), mean(aux, False)), (g_table, g_params),
                            lr=lr_at(state.step), noise=noise, delta_grad=delta_grad,
                            batch_rows=int(batch["labels"].numel()) * width)

    return train_step


def wrap_host_refresh(step_fn, cfg: tfm.ModelConfig, tcfg: LMTrainerConfig):
    """Host-side periodic table refresh around an LM step, for
    ``method.has_host_refresh`` (prune's DeepLight mask): after each step the
    schedule clock is synced to the step count and every ``refresh_every``
    steps the mask is recomputed (``EmbeddingMethod.after_step``).  The
    identity for every other method, so a training loop applies it
    unconditionally, as the reference's does.

    Wrapped under a sharding context whose table splits, a refresh step
    reads the whole table, as the reference's does: the shards are
    all-gathered over the model group, refreshed (prune's threshold the
    whole table's quantile, bitwise the one-process one), and this rank's
    block cut back; the other steps sync the clock on the shard."""
    spec = embedding_spec_of(cfg, tcfg)
    method = methods.get(spec.method)
    if not method.has_host_refresh:
        return step_fn
    sh = _shards(cfg, tcfg)
    whole_refresh = sh is not None and sh.table_split
    local = spec if sh is None else sh.spec

    def step_with_refresh(state: LMTrainState, batch: dict, *args, **kwargs):
        state, m = step_fn(state, batch, *args, **kwargs)
        table = state.table
        if whole_refresh and state.step % method.refresh_every(spec) == 0:
            whole = method.after_step(sharding.gather_tree(table, sh.specs.table, sh.mesh),
                                      state.step, spec)
            table = sharding.shard_tree(whole, sh.specs.table, sh.mesh)
        else:
            table = method.after_step(table, state.step, local)
        return state._replace(table=table), m

    return step_with_refresh


def make_eval_step(cfg: tfm.ModelConfig, tcfg: LMTrainerConfig | None = None):
    """``eval_step(state, batch) -> {"loss", "aux_loss"}`` over the eval table."""
    def eval_step(state: LMTrainState, batch: dict):
        with torch.no_grad():
            loss, aux = tfm.loss_fn(state.params, table_fp_of(state, cfg, tcfg), batch, cfg)
        return {"loss": loss, "aux_loss": aux}

    return eval_step
