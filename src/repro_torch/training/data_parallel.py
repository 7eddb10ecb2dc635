"""Data-parallel training with exact or SR-compressed gradient sync (port of
repro/training/data_parallel.py, on ``torch.distributed``).

Each rank is one process on one device, a member of ``group`` (the default
process group unless one is passed: the reference's mesh ``data`` axis).
The wrapper around either trainer's step

  * keeps the training state replicated: every rank starts from the same
    state, draws the same dropout masks and write-back noise from its
    replicated generator, and applies the same synced update;
  * takes the GLOBAL batch and trains on this rank's contiguous slice of
    its leading dimension (the reference's ``P('data')`` sharding);
  * syncs the dense and embedding gradients between backward and update at
    ``sync_bits``:

      - 32: the exact fp32 mean, all-gathered and summed in rank order
        (``collectives.exact_pmean_local``);
      - 2..8: the paper's SR quantizer applied to communication
        (``collectives.compressed_pmean_local``): codes against a shared
        step, an int32 sum (packed uint8 on the wire at 2 and 4 bits), one
        de-quantize.

Exactness contract (tests/test_torch_data_parallel.py,
``chip_smoke.py`` phase 12): the n-rank ``make_*_dp_step`` is bitwise, step
for step, the one-process microbatched ``make_*_microbatch_step`` with
``n_shards == n``, at every ``sync_bits``: both sum the same rank-ordered
gradients in the same order, or the same integer codes, and both key the
noise alike.

SR noise keying: the noise is never drawn from the state's generator.  It
comes from a generator of its own per (``sync_seed``, step, gradient leaf,
rank) (:func:`keyed_noise`), the reference's ``fold_in(fold_in(fold_in(
base, step), leaf), rank)`` chain as a path of integers; ALPT's Delta
gradient takes the leaf ``_DELTA_SALT`` (a single leaf keyed directly, a
composed table's leaves folded in turn).  ``sync_noise`` replaces the draw
(a test hands in the reference's).

Gradient leaves are taken in the reference's pytree order: the embedding
gradient's leaves, then the backbone's in its ``param_tree`` (CTR) or the
transformer's ``tree_leaves`` order (LM), so a leaf has the reference's
index.  Embedding methods sync their dense formulation: the trainable
leaves of a float-leaf method, the [n, d] de-quantized table of an integer
one (plus ALPT's synced Delta gradient), the only shape every rank shares.
The wrapper never names a method; it keys off the capability flags (a
``has_host_refresh`` method's state is refreshed on the host after the
step, as the reference's ``make_*_step`` functions wrap theirs).  The LM
leaves follow the parameter tree, so the SSM and MoE families sync their
own leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import methods
from repro_torch.core import quant
from repro_torch.dist import collectives
from repro_torch.models import ctr as ctr_models
from repro_torch.optim import tree_leaves, tree_like
from repro_torch.training import lm_trainer

# Key salt separating the ALPT Delta-gradient sync from the per-leaf syncs
# of the main gradient (leaf indices are small integers).
_DELTA_SALT = 0x0D317A

# 32 = exact fp32; any width quant.code_bounds takes is a valid code sync.
_VALID_BITS = (32,) + tuple(range(2, 9))

#: ``sync_noise(path, rank, shape, device) -> f32 tensor``: rank ``rank``'s
#: uniform draw for the sync of the leaf keyed by ``path``.
NoiseFn = Callable[[tuple, int, tuple, torch.device], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Data-parallel sync policy.

    ``sync_bits``: 32 = exact fp32 mean; 2..8 = SR-compressed codes.
    ``sync_seed``: base seed of the SR compression noise.
    ``use_kernels``: quantize the compressed sync through the ``sr_round``
    kernel (bitwise the plain version, so the twins hold either way).
    """

    sync_bits: int = 32
    sync_seed: int = 0
    use_kernels: bool = True

    def __post_init__(self):
        if self.sync_bits not in _VALID_BITS:
            raise ValueError(f"sync_bits must be one of {_VALID_BITS}, got {self.sync_bits}")


def _mix(*words: int) -> int:
    """A 63-bit seed from a sequence of integers (splitmix64 over each)."""
    h = 0x243F6A8885A308D3
    for w in words:
        h = (h ^ (int(w) & 0xFFFFFFFFFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
        h = (h + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h >> 1


def keyed_noise(sync_seed: int) -> NoiseFn:
    """The sync's noise: a uniform draw from a generator seeded by
    (``sync_seed``, path, rank) on ``device``, independent of the state."""
    def draw(path, rank, shape, device):
        generator = torch.Generator(device=device)
        generator.manual_seed(_mix(sync_seed, *path, rank))
        return quant.sr_noise(generator, tuple(shape))

    return draw


def _resolve(dp: DPConfig | None, sync_bits_default: int) -> DPConfig:
    return DPConfig(sync_bits=sync_bits_default) if dp is None else dp


# --------------------------------------------------------------------- syncs


class GradSync:
    """The gradient sync of one step builder: the n-rank all-reduce over
    ``group`` (:meth:`leaf`) and its one-process twin over the ranks'
    stacked gradients (:meth:`stacked`), keyed alike."""

    def __init__(self, dp: DPConfig, sync_noise: NoiseFn | None = None, group=None):
        self.dp = dp
        self.noise = keyed_noise(dp.sync_seed) if sync_noise is None else sync_noise
        self.group = group

    def leaf(self, g: torch.Tensor, path: tuple) -> torch.Tensor:
        dp = self.dp
        if dp.sync_bits == 32:
            return collectives.exact_pmean_local(g, self.group)
        u = self.noise(path, dist.get_rank(self.group), tuple(g.shape), g.device)
        return collectives.compressed_pmean_local(g, u, dp.sync_bits, self.group,
                                                  dp.use_kernels)

    def stacked(self, stack: list, path: tuple) -> torch.Tensor:
        dp = self.dp
        if dp.sync_bits == 32:
            return collectives.exact_pmean_stacked(stack)
        us = [self.noise(path, r, tuple(g.shape), g.device) for r, g in enumerate(stack)]
        return collectives.compressed_pmean_stacked(stack, us, dp.sync_bits, dp.use_kernels)

    def tree(self, leaves: list, step: int, stacked: bool = False) -> list:
        """Every gradient leaf synced, leaf ``i`` keyed ``(step, i)``
        (``stacked``: each leaf a list of the ranks' gradients)."""
        sync = self.stacked if stacked else self.leaf
        return [sync(g, (step, i)) for i, g in enumerate(leaves)]

    def delta(self, leaves: list, step: int, stacked: bool = False) -> list:
        """ALPT's Delta gradient synced: one leaf keyed ``(step, SALT)``, the
        leaves of a composed table ``(step, SALT, i)``."""
        sync = self.stacked if stacked else self.leaf
        if len(leaves) == 1:
            return [sync(leaves[0], (step, _DELTA_SALT))]
        return [sync(g, (step, _DELTA_SALT, i)) for i, g in enumerate(leaves)]


def _transpose(per_shard: list[list]) -> list[list]:
    """[shard][leaf] -> [leaf][shard]."""
    return [list(x) for x in zip(*per_shard)]


def _shards(t: torch.Tensor, n: int, dim: int = 0) -> list[torch.Tensor]:
    if t.shape[dim] % n:
        raise ValueError(f"batch dim {t.shape[dim]} not divisible by n_shards={n}")
    return list(torch.chunk(t, n, dim=dim))


def _require_group(group):
    """``group``, once ``torch.distributed`` is initialized in this process."""
    if not dist.is_initialized():
        raise RuntimeError("data parallel needs torch.distributed initialized "
                           "(init_process_group): one process per rank")
    return group


# ------------------------------------------------------------- CTR trainers


def _check_ctr(trainer) -> None:
    if trainer.cfg.cache_rows:
        raise ValueError("data parallel trains the dense formulation, which reads the whole "
                         "table: a trainer with a hot-row cache (cache_rows > 0) takes the "
                         "sparse single-device step only")


class CTRGradLeaves:
    """A CTR gradient ``(g_emb, g_dense)`` as leaves in the reference's
    pytree order (the backbone's ``param_tree``, not ``parameters()``)."""

    def __init__(self, dense: torch.nn.Module):
        pos = {id(p): i for i, p in enumerate(dense.parameters())}
        self.order = [pos[id(p)] for p in tree_leaves(dense.param_tree())]

    def flat(self, grads) -> list:
        g_emb, g_dense = grads
        return tree_leaves(g_emb) + [g_dense[j] for j in self.order]

    def unflat(self, grads, leaves: list):
        g_emb, _ = grads
        k = len(tree_leaves(g_emb))
        g_dense = [None] * len(self.order)
        for j, g in zip(self.order, leaves[k:]):
            g_dense[j] = g
        return tree_like(g_emb, leaves[:k]), g_dense


def _ctr_step(trainer, sync: GradSync, n_shards: int | None):
    """The CTR step around ``sync``: the n-rank step (``n_shards`` None) or
    its one-process twin over ``n_shards`` microbatches."""
    _check_ctr(trainer)
    method, spec = trainer.method, trainer.spec
    grad_fn, apply_fn = trainer.build_grad_fn(), trainer.build_apply_fn()
    delta_fn = trainer.build_delta_grad_fn() if method.has_learned_step else None

    def step(state, ids, labels, *, noise=None, masks=None):
        lr = trainer._lr_at(state.step)
        ids, labels = trainer._batch(ids, labels)
        if n_shards is None:
            n, rank = dist.get_world_size(sync.group), dist.get_rank(sync.group)
            shards = [(_shards(ids, n)[rank], _shards(labels, n)[rank])]
        else:
            n = n_shards
            shards = list(zip(_shards(ids, n), _shards(labels, n)))
        # One set of dropout masks at the shard's size, reused by every
        # shard as each rank draws it; then the table's write-back draw.
        if masks is None:
            masks = ctr_models.dropout_masks(trainer.model_cfg, state.generator,
                                             shards[0][0].shape[0])
        if noise is None:
            noise = method.dense_noise(state.generator, state.emb_state, spec)
        leaves_of = CTRGradLeaves(state.dense)
        outs = [grad_fn(state, i, y, masks) for i, y in shards]
        if n_shards is None:
            (loss, grads), = outs
            synced = sync.tree(leaves_of.flat(grads), state.step)
            loss = collectives.exact_pmean_local(loss, sync.group)
        else:
            grads = outs[0][1]
            synced = sync.tree(_transpose([leaves_of.flat(g) for _, g in outs]), state.step,
                               stacked=True)
            loss = collectives.exact_pmean_stacked([x for x, _ in outs])
        grads = leaves_of.unflat(grads, synced)

        delta_grad = None
        if delta_fn is not None:
            def delta_grad(w_new, step_vec, dense, gscale):
                gs = [delta_fn(w_new, step_vec, dense, i, y, masks, gscale) for i, y in shards]
                like = gs[0]
                if n_shards is None:
                    out = sync.delta(tree_leaves(like), state.step)
                else:
                    out = sync.delta(_transpose([tree_leaves(g) for g in gs]), state.step,
                                     stacked=True)
                return tree_like(like, out)

        return apply_fn(state, loss, grads, lr=lr, noise=noise, delta_grad=delta_grad,
                        batch_rows=ids.numel())

    if method.has_host_refresh:
        step = trainer.wrap_host_refresh(step)
    return step


def make_ctr_dp_step(trainer, group=None, dp: DPConfig | None = None, *,
                     sync_noise: NoiseFn | None = None):
    """Data-parallel CTR step over ``group``: ``step(state, ids, labels, *,
    noise=None, masks=None) -> (state, metrics)``, run by every rank.

    ``ids`` / ``labels`` are the GLOBAL batch (its leading dimension a
    multiple of the ranks); each rank trains on its slice, syncs the
    gradients at ``dp.sync_bits`` (default ``trainer.cfg.dp_sync_bits``) and
    applies the same update to its replica.  The loss metric is the exact
    mean over the ranks at every width.  ``noise`` / ``masks`` override the
    generator's write-back draw and dropout masks, as in ``train_step``.
    """
    dp = _resolve(dp, trainer.cfg.dp_sync_bits)
    return _ctr_step(trainer, GradSync(dp, sync_noise, _require_group(group)), None)


def make_ctr_microbatch_step(trainer, n_shards: int, dp: DPConfig | None = None, *,
                             sync_noise: NoiseFn | None = None):
    """One-process microbatched CTR step: the batch's ``n_shards`` slices
    through the same backward, their gradients combined by the collectives'
    twins; bitwise :func:`make_ctr_dp_step` on ``n_shards`` ranks, at every
    ``sync_bits``."""
    dp = _resolve(dp, trainer.cfg.dp_sync_bits)
    return _ctr_step(trainer, GradSync(dp, sync_noise), int(n_shards))


# -------------------------------------------------------------- LM trainers


def _lm_shards(batch: dict, n: int) -> dict:
    """``{key: [shard, ...]}`` of an LM batch over its batch dimension: the
    leading one (an encoder's ``embeds`` [B, T, d] among them), but
    dimension 1 of M-RoPE ``positions`` [3, B, T].  (The reference refuses
    such positions; its CLI refuses the mixed archs in DP mode, as the
    port's does.)"""
    return {k: _shards(v, n, dim=1 if k == "positions" and v.ndim == 3 else 0)
            for k, v in batch.items()}


def make_lm_dp_step(cfg, tcfg, group=None, dp: DPConfig | None = None, *,
                    sync_noise: NoiseFn | None = None, lr_schedule=None):
    """Data-parallel LM step over ``group``: ``step(state, batch, noise=None)
    -> (state, metrics)``, run by every rank on the GLOBAL ``batch`` (every
    leaf leads with the batch dimension but M-RoPE ``positions`` [3, B, T],
    sliced on B); the LM trainer's own step with its
    sync hooks filled in (``lr_schedule`` passed on to it).  ``loss`` and
    ``aux_loss`` are exact means over the ranks."""
    dp = _resolve(dp, tcfg.dp_sync_bits)
    sync = GradSync(dp, sync_noise, _require_group(group))
    n = dist.get_world_size(sync.group)

    def grad_sync(grads, step):
        return tree_like(grads, sync.tree(tree_leaves(grads), step))

    def step_grad_sync(g_step, step):
        return tree_like(g_step, sync.delta(tree_leaves(g_step), step))

    hooked = lm_trainer.make_train_step(cfg, tcfg, lr_schedule, grad_sync=grad_sync,
                                        step_grad_sync=step_grad_sync, dp_size=n)

    def step(state, batch, noise=None):
        rank = dist.get_rank(sync.group)
        local = {k: v[rank] for k, v in _lm_shards(batch, n).items()}
        new_state, metrics = hooked(state, local, noise)
        metrics = dict(metrics)
        metrics["loss"] = collectives.exact_pmean_local(metrics["loss"], sync.group)
        metrics["aux_loss"] = collectives.exact_pmean_local(metrics["aux_loss"], sync.group)
        return new_state, metrics

    return lm_trainer.wrap_host_refresh(step, cfg, tcfg)


def make_lm_microbatch_step(cfg, tcfg, n_shards: int, dp: DPConfig | None = None, *,
                            sync_noise: NoiseFn | None = None, lr_schedule=None):
    """One-process microbatched LM step: bitwise :func:`make_lm_dp_step` on
    ``n_shards`` ranks (the same ``lr_schedule``)."""
    lm_trainer.check_trainable(cfg, tcfg)
    dp = _resolve(dp, tcfg.dp_sync_bits)
    sync = GradSync(dp, sync_noise)
    spec = lm_trainer.embedding_spec_of(cfg, tcfg)
    method = methods.get(spec.method)
    lr_at = lm_trainer.make_lr_fn(tcfg, lr_schedule)
    grad_fn = lm_trainer.make_grad_fn(cfg, tcfg)
    apply_fn = lm_trainer.make_apply_fn(cfg, tcfg)
    delta_fn = lm_trainer.make_delta_grad_fn(cfg, tcfg) if method.has_learned_step else None

    def step(state, batch, noise=None):
        if noise is None:
            noise = method.dense_noise(state.generator, state.table, spec)
        parts = _lm_shards(batch, n_shards)
        shards = [{k: v[i] for k, v in parts.items()} for i in range(n_shards)]
        outs = [grad_fn(state, shard) for shard in shards]
        grads = outs[0][1]
        synced = sync.tree(_transpose([tree_leaves(g) for _, g in outs]), state.step,
                           stacked=True)
        loss = collectives.exact_pmean_stacked([la[0] for la, _ in outs])
        aux = collectives.exact_pmean_stacked([la[1] for la, _ in outs])

        delta_grad = None
        if delta_fn is not None:
            def delta_grad(w_new, step_vec, new_params, gscale):
                gs = [delta_fn(w_new, step_vec, new_params, shard, gscale) for shard in shards]
                out = sync.delta(_transpose([tree_leaves(g) for g in gs]), state.step,
                                 stacked=True)
                return tree_like(gs[0], out)

        return apply_fn(state, (loss, aux), tree_like(grads, synced), lr=lr_at(state.step),
                        noise=noise, delta_grad=delta_grad,
                        batch_rows=int(batch["labels"].numel()))

    return lm_trainer.wrap_host_refresh(step, cfg, tcfg)


# ------------------------------------------------------- wire-byte reporting


def wire_report(grads, dp: DPConfig | int) -> dict:
    """Per-step, per-rank gradient wire bytes: at ``sync_bits``, the fp32
    baseline and their ratio.  ``grads`` is a sequence of tensors or shapes
    (:func:`ctr_grad_shapes` / :func:`lm_grad_shapes`)."""
    bits = dp.sync_bits if isinstance(dp, DPConfig) else int(dp)
    return {
        "sync_bits": bits,
        "wire_bytes_per_step": collectives.sync_wire_bytes(grads, bits),
        "fp32_wire_bytes_per_step": collectives.sync_wire_bytes(grads, 32),
        "compression_ratio": collectives.sync_compression_ratio(grads, bits),
    }


def _emb_grad_shapes(method, state, spec) -> list:
    if method.is_integer_table:
        return [(spec.n, spec.d)]  # the dense [n, d] table's gradient
    return [tuple(t.shape) for t in tree_leaves(method.trainable_params(state, spec))]


def ctr_grad_shapes(trainer, state, batch_size: int | None = None,
                    n_fields: int | None = None) -> list:
    """Shapes of the gradient leaves one CTR rank syncs, in sync order (the
    reference's signature; the shapes do not depend on the batch)."""
    shapes = _emb_grad_shapes(trainer.method, state.emb_state, trainer.spec)
    return shapes + [tuple(p.shape) for p in tree_leaves(state.dense.param_tree())]


def lm_grad_shapes(cfg, tcfg, state, batch=None) -> list:
    """Shapes of the gradient leaves one LM rank syncs, in sync order."""
    spec = lm_trainer.embedding_spec_of(cfg, tcfg)
    shapes = _emb_grad_shapes(methods.get(spec.method), state.table, spec)
    return shapes + [tuple(p.shape) for p in tree_leaves(state.params)]
