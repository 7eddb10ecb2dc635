"""End-to-end CTR training for every registered embedding method on DCN or
DeepFM (port of repro/training/ctr_trainer.py).

One trainer, any method; the trainer never names a method.  It keys off
the capability surfaces:

  float-leaf methods    : Adam over the method's leaves (one ``adam_update``
                          over them, with decoupled weight decay) beside
                          Adam over the dense params
  integer-table methods : the method's ``fused_row_step`` (Eq. 8 for LPT,
                          Algorithm 1 for ALPT, product-rule row steps for
                          qr_*, one row step per bit-width group for mixed)
  host refresh          : ``wrap_host_refresh`` (prune's DeepLight mask)

The paper's protocol (§4.1): Adam lr 1e-3, tenfold decay boundaries,
decoupled weight decay on embeddings, Delta lr 2e-5.  Every SR draw and
dropout mask comes from the state's ``torch.Generator``;
:meth:`CTRTrainer.train_step` takes ``noise=`` and ``masks=`` so a test can
hand in the reference's draws instead.  :meth:`CTRTrainer.save` /
:meth:`CTRTrainer.restore` checkpoint a state (``repro_torch.checkpoint``).

``TrainerConfig.cache_rows`` composes a device hot-row cache
(:mod:`repro_torch.storage.tiered`) over every cacheable sub-table of an
integer table (``method.storage_spec``): the step's gathers and row steps
take the routed kernels, and after each step the policy observes the
batch's ids (``write=True``: the step wrote cached rows to the hot tier
only) and applies its moves.  Cache-on is bitwise cache-off:
:meth:`CTRTrainer.export_state` folds the dirty rows back, and checkpoints
hold that state.

The data-parallel hooks (:meth:`CTRTrainer.build_grad_fn`,
:meth:`~CTRTrainer.build_apply_fn`, :meth:`~CTRTrainer.build_delta_grad_fn`)
split the step at the gradient sync on the method's *dense* formulation,
the [n, d] table's gradient every rank shares
(:mod:`repro_torch.training.data_parallel`); ``TrainerConfig.dp_sync_bits``
is its sync width.

``TrainerConfig.guard`` turns on the non-finite guard
(:func:`repro_torch.faults.wrap_ctr_step`, where the reference applies it:
around the fused step, inside the host refresh): a step whose loss or dense
parameters come out non-finite is skipped, the state returned to its value
before the step with the step counter and the generator advanced, and the
cache's policy still observes the batch.  It hosts the ``trainer.nonfinite``
and ``alpt.delta`` seams of the fault plan installed at construction;
``CTRTrainer.guard_stats`` adds up its counters.  Off, the step runs as
before.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import faults, methods, metrics
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import alpt as alpt_core
from repro_torch.core import quant
from repro_torch.methods import layout
from repro_torch.models import ctr as ctr_models
from repro_torch.obs.trace import tracer
from repro_torch.optim import OptState, adam_init, adam_update, tree_leaves, tree_like
from repro_torch.storage.tiered import HotRowCache


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    spec: methods.EmbeddingSpec
    dcn: ctr_models.DCNConfig | None = None
    seed: int = 0
    lr: float = 1e-3
    emb_weight_decay: float = 5e-8
    lr_boundaries: tuple[int, ...] = ()  # steps at which lr /= 10
    model: str = "dcn"  # 'dcn' | 'deepfm' (spec.d = deepfm.emb_dim + 1)
    deepfm: ctr_models.DeepFMConfig | None = None
    # > 0: a device hot-row cache of this many rows over every cacheable
    # sub-table of the table (capped at its rows); integer tables only.
    cache_rows: int = 0
    # Gradient-sync width of data-parallel training
    # (repro_torch.training.data_parallel): 32 = exact fp32, 2..8 = SR codes.
    dp_sync_bits: int = 32
    # The opt-in non-finite guard (repro_torch.faults.guards): skip a step
    # whose loss or dense params come out NaN / Inf (the state rolls back,
    # the step counter and generator advance).  Off: the step is untouched.
    guard: bool = False

    @property
    def model_cfg(self):
        """The backbone's config: ``dcn`` or ``deepfm`` as ``model`` says."""
        if self.model not in ctr_models.MODELS:
            raise ValueError(f"unknown CTR model {self.model!r}; have {sorted(ctr_models.MODELS)}")
        cfg = getattr(self, self.model)
        if cfg is None:
            raise ValueError(f"model={self.model!r} needs TrainerConfig.{self.model}")
        return cfg


class TrainState(NamedTuple):
    emb_state: Any  # the method's table state
    dense: torch.nn.Module  # the backbone (DCN or DeepFM)
    step: int
    dense_opt: OptState | None = None  # Adam over dense.parameters()
    emb_opt: OptState | None = None  # Adam over the float embedding leaves
    generator: torch.Generator | None = None  # SR noise and dropout masks of the steps


def init_state(cfg: TrainerConfig, *, device: str | torch.device = "cuda") -> TrainState:
    """Embedding table then the backbone's params, both drawn from one
    generator seeded with ``cfg.seed`` on ``device`` (``cuda`` unless the
    caller asks for the CPU; raises if CUDA is asked for and absent).  The
    same generator then draws the training steps' SR noise and dropout."""
    dev = device_mod.resolve(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.seed)
    method = methods.get(cfg.spec.method)
    emb_state = method.init(generator, cfg.spec)
    dense = ctr_models.MODELS[cfg.model][2](cfg.model_cfg, generator)
    emb_params = method.trainable_params(emb_state, cfg.spec)
    return TrainState(
        emb_state=emb_state, dense=dense, step=0,
        dense_opt=adam_init(list(dense.parameters())),
        emb_opt=None if emb_params is None else adam_init(tree_leaves(emb_params)),
        generator=generator,
    )


class CTRCheckpoint(NamedTuple):
    """A CTR training state as a checkpoint tree: the reference's
    ``TrainState`` fields and leaves, with the port's generator state (a
    uint8 tensor) where the reference keeps its threefry ``rng``."""

    emb_state: Any
    dense_params: Any
    dense_opt: Any
    emb_opt: Any
    step: Any
    generator: Any


def checkpoint_tree(cfg: TrainerConfig, state: TrainState) -> CTRCheckpoint:
    """The checkpoint tree of a CTR training state: the table state as the
    reference's (a code container as its bytes), the backbone's params and
    their Adam state in the reference's pytree, a float-leaf method's Adam
    state laid out as its params, the step, and the generator's state.
    Leaves are the state's own tensors: nothing is copied here."""
    params = methods.get(cfg.spec.method).trainable_params(state.emb_state, cfg.spec)
    return CTRCheckpoint(
        emb_state=state.emb_state, dense_params=state.dense.param_tree(),
        dense_opt=ckpt.opt_tree(state.dense_opt,
                                lambda leaves: ctr_models.params_like(state.dense, leaves)),
        emb_opt=ckpt.opt_tree(state.emb_opt, params), step=state.step,
        generator=state.generator.get_state())


def state_from_checkpoint(cfg: TrainerConfig, tree, *,
                          device: str | torch.device = "cuda") -> TrainState:
    """The ``TrainState`` of a restored checkpoint tree (the nested tree
    ``CheckpointManager.restore`` returns, of a port or a reference
    checkpoint: the table in ``methods.layout``'s layout, the backbone's
    params and ``dense_opt`` in the reference's pytree), its leaves on
    ``device``; a missing optimizer state loads as zeros.  The generator is
    the saved one, or for a reference checkpoint
    ``checkpoint.manager.reference_generator_seed`` of ``cfg.seed`` and
    the step."""
    dev = device_mod.resolve(device)
    spec = cfg.spec
    backbone = ctr_models.MODELS[cfg.model][1]

    def dense_moments(t):  # a reference pytree -> tensors in parameters() order
        module = backbone(cfg.model_cfg, device=dev).load_jax_params(t)
        return [p.detach().clone() for p in module.parameters()]

    table = layout.emb_state_from_numpy(spec, tree["emb_state"], device=dev)
    dense = backbone(cfg.model_cfg, device=dev).load_jax_params(tree["dense_params"])
    params = methods.get(spec.method).trainable_params(table, spec)
    step = int(tree["step"])
    return TrainState(
        emb_state=table, dense=dense, step=step,
        dense_opt=ckpt.opt_from_tree(tree.get("dense_opt"), list(dense.parameters()),
                                     dense_moments),
        emb_opt=None if params is None else ckpt.opt_from_tree(
            tree.get("emb_opt"), tree_leaves(params), lambda t: ckpt.float_leaves(t, dev)),
        generator=ckpt.generator_from_tree(tree, cfg.seed, step, dev))


class CTRTrainer:
    def __init__(self, cfg: TrainerConfig, *, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.spec = cfg.spec
        self.model_cfg = cfg.model_cfg
        self.method = methods.get(cfg.spec.method)
        self.device = device_mod.resolve(device)
        self._step = self._train_step
        self.guard_stats = faults.GuardStats() if cfg.guard else None
        if cfg.guard:
            self._step = faults.wrap_ctr_step(self._step, method=self.method, spec=self.spec)
        if self.method.has_host_refresh:
            self._step = self.wrap_host_refresh(self._step)
        self._caches: list = []  # [(CacheSlot, HotRowCache)]
        self._slots = self.method.storage_spec(self.spec) if cfg.cache_rows else ()
        if cfg.cache_rows and not self._slots:
            raise ValueError(f"cache_rows > 0 but method {self.spec.method!r} exposes no "
                             "cacheable storage slots (integer-table methods only)")

    def init_state(self) -> TrainState:
        return self.import_state(init_state(self.cfg, device=self.device))

    # ------------------------------------------------------------ cache

    def _install_caches(self, emb_state):
        """An empty hot-row cache over each cacheable slot of the table."""
        self._caches = []
        for slot in self._slots:
            sub = slot.get(emb_state)
            cache = HotRowCache(max(1, min(int(self.cfg.cache_rows), slot.rows)),
                                sub.codes.shape[0], name=slot.name)
            emb_state = slot.put(emb_state, sub._replace(codes=cache.wrap(sub.codes)))
            self._caches.append((slot, cache))
        return emb_state

    def _maintain_caches(self, state: TrainState, ids) -> None:
        """After a step: each slot's policy observes the batch's ids
        (``write=True``) and its moves are applied, in place."""
        flat = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids).reshape(-1)
        for slot, cache in self._caches:
            cache.observe_apply(slot.get(state.emb_state).codes, slot.local_ids(flat),
                                write=True)

    def export_state(self, state: TrainState) -> TrainState:
        """The cache-off state: each slot's backing with its dirty hot rows
        folded in (a copy; the live state trains on), bitwise what an
        uncached run holds.  What checkpoints and serving exports take."""
        emb_state = state.emb_state
        for slot, cache in self._caches:
            sub = slot.get(emb_state)
            emb_state = slot.put(emb_state, sub._replace(codes=cache.unwrap(sub.codes)))
        return state._replace(emb_state=emb_state)

    def import_state(self, state: TrainState) -> TrainState:
        """``state`` (cache-off, e.g. restored) with empty caches installed
        when ``cache_rows`` asks for them; membership restarts cold, which
        the training math never sees."""
        if not self.cfg.cache_rows:
            return state
        return state._replace(emb_state=self._install_caches(state.emb_state))

    def cache_stats(self) -> list[dict]:
        return [cache.stats() for _, cache in self._caches]

    @property
    def caches(self) -> list:
        """``[(CacheSlot, HotRowCache)]`` of the state last installed."""
        return list(self._caches)

    def save(self, manager: ckpt.CheckpointManager, state: TrainState, *,
             force: bool = False) -> bool:
        """Checkpoint ``state`` at its step through ``manager`` when its
        cadence says so, or when ``force``d: the reference's ``TrainState``
        leaves (:func:`checkpoint_tree`), the generator's state, and a
        manifest with the embedding metadata and the config's hash.
        Returns whether it saved.  Under a cache it saves :meth:`export_state`:
        the files are those of a run without one."""
        if not (force or manager.should_save(state.step)):
            return False
        meta = {"config_hash": ckpt.config_hash(self.cfg), **ckpt.embedding_manifest(self.spec)}
        return manager.maybe_save(checkpoint_tree(self.cfg, self.export_state(state)),
                                  state.step, force=force, extra_meta=meta)

    def restore(self, manager: ckpt.CheckpointManager, *,
                step: int | None = None) -> TrainState:
        """The state of ``step`` (default: the newest committed checkpoint
        that passes verification) on this trainer's device; a reference
        checkpoint loads too (:func:`state_from_checkpoint`).  Another
        config's table (method, schema, bits or packing in the manifest, or
        the leaves themselves) raises ``ValueError``.  Under a cache the
        caches are installed anew, empty (:meth:`import_state`)."""
        tree, _ = manager.restore(step=step, device=self.device, spec=self.spec)
        ckpt.check_table(tree["emb_state"], self.spec)
        return self.import_state(state_from_checkpoint(self.cfg, tree, device=self.device))

    def _lr_at(self, step: int) -> float:
        """The reference's ``_lr_at`` in float32: lr times 0.1 per boundary passed."""
        lr = np.float32(self.cfg.lr)
        for b in self.cfg.lr_boundaries:
            lr = lr * (np.float32(0.1) if step >= b else np.float32(1.0))
        return float(lr)

    def _batch(self, ids, labels):
        ids = torch.as_tensor(np.asarray(ids, np.int32), device=self.device)
        labels = torch.as_tensor(np.asarray(labels, np.float32), device=self.device)
        return ids, labels

    def train_step(self, state: TrainState, ids, labels, *, noise=None, masks=None):
        """One step on a batch (ids int32 [B, F], labels [B]) -> ``(state, metrics)``.

        Integer tables are updated in place; the returned state shares their
        tensors.  ``noise`` overrides the generator's SR draws: a sequence of
        ``method.noise_draws(spec)`` tensors [B*F, d_alloc].  ``masks``
        overrides the dropout keep-masks (``models.ctr.dropout_masks``).
        Under a cache, the policy then observes ``ids`` and moves rows.

        Traced (:mod:`repro_torch.obs`), the step is one ``train.step`` span
        fenced on its metrics and the cache maintenance one
        ``train.writeback`` span, as the reference's; untraced, both are the
        shared null context and the fence passes through.
        """
        tr = tracer()
        with tr.span("train.step", step=state.step):
            state, m = self._step(state, ids, labels, noise=noise, masks=masks)
            tr.fence(m)
        if self.guard_stats is not None:
            self.guard_stats.observe(m)
        with tr.span("train.writeback"):
            self._maintain_caches(state, ids)
        return state, m

    def _train_step(self, state: TrainState, ids, labels, *, noise=None, masks=None):
        lr = self._lr_at(state.step)
        ids, labels = self._batch(ids, labels)
        dense = state.dense
        dense_params = list(dense.parameters())
        if masks is None:
            masks = ctr_models.dropout_masks(self.model_cfg, state.generator, ids.shape[0])

        def loss_from_rows(rows):
            return ctr_models.bce_loss(ctr_models.logits_from_rows(dense, rows, masks), labels)

        if not self.method.is_integer_table:
            return self._float_leaf_step(state, ids, lr, loss_from_rows, dense_params)

        if noise is None:
            shape = (ids.numel(), self.spec.d_padded)
            noise = [quant.sr_noise(state.generator, shape)
                     for _ in range(self.method.noise_draws(self.spec))]
        dense_opt = state.dense_opt

        def update_dense(grads):
            nonlocal dense_opt
            new_params, dense_opt = adam_update(grads, dense_opt, dense_params, lr,
                                                use_kernel=self.spec.use_kernels)
            with torch.no_grad():
                for p, new in zip(dense_params, new_params):
                    p.copy_(new)

        emb_state, m = self.method.fused_row_step(
            state.emb_state, ids, spec=self.spec, loss_from_rows=loss_from_rows,
            dense_params=dense_params, update_dense=update_dense, lr=lr,
            weight_decay=self.cfg.emb_weight_decay, noise=list(noise),
        )
        new_state = state._replace(emb_state=emb_state, step=state.step + 1,
                                   dense_opt=dense_opt)
        return new_state, {"lr": lr, **m}

    def _float_leaf_step(self, state, ids, lr, loss_from_rows, dense_params):
        """Adam over the method's leaves (in the reference's pytree order) and
        over the dense params, from one backward."""
        spec, method = self.spec, self.method
        params = method.trainable_params(state.emb_state, spec)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        with torch.enable_grad():
            emb_state = method.with_params(state.emb_state, tree_like(params, leaves), spec)
            loss = loss_from_rows(method.lookup(emb_state, ids, spec))
            grads = torch.autograd.grad(loss, [*leaves, *dense_params])
        g_emb, g_dense = grads[: len(leaves)], grads[len(leaves):]
        new_dense, dense_opt = adam_update(g_dense, state.dense_opt, dense_params, lr,
                                           use_kernel=spec.use_kernels)
        new_leaves, emb_opt = adam_update(g_emb, state.emb_opt, [t.detach() for t in leaves], lr,
                                          weight_decay=self.cfg.emb_weight_decay,
                                          use_kernel=spec.use_kernels)
        with torch.no_grad():
            for p, new in zip(dense_params, new_dense):
                p.copy_(new)
        emb_state = method.with_params(state.emb_state, tree_like(params, new_leaves), spec)
        new_state = state._replace(emb_state=emb_state, step=state.step + 1,
                                   dense_opt=dense_opt, emb_opt=emb_opt)
        return new_state, {"loss": loss.detach(), "lr": lr}

    # ------------------------------------------- grad/apply split (DP hooks)
    #
    # The fused step above is the single-device path (sparse row steps for
    # integer tables).  Data parallelism syncs the gradients *between*
    # backward and update, so the same math is also a (grad_fn, apply_fn)
    # pair on the method's dense formulation (``dense_params`` /
    # ``dense_lookup`` / ``dense_update``): the shape that is the same on
    # every rank.  Dropout masks and SR draws are operands, as in
    # :meth:`train_step`.

    def build_grad_fn(self):
        """Backward of one (micro)batch: ``grad_fn(state, ids, labels, masks)
        -> (loss, (g_emb, g_dense))``.  ``g_emb`` is laid out as the method's
        ``dense_params`` (the trainable leaves of a float-leaf method, the
        live [n, d] de-quantized table of an integer one), ``g_dense`` a list
        in ``state.dense.parameters()`` order; ``masks`` are the dropout
        keep-masks (``models.ctr.dropout_masks``) or None."""
        spec, method = self.spec, self.method

        def grad_fn(state: TrainState, ids, labels, masks=None):
            dense = method.dense_params(state.emb_state, spec)
            emb = [t.detach().requires_grad_(True) for t in tree_leaves(dense)]
            dense_params = list(state.dense.parameters())
            with torch.enable_grad():
                rows = method.dense_lookup(state.emb_state, tree_like(dense, emb), ids, spec)
                loss = ctr_models.bce_loss(
                    ctr_models.logits_from_rows(state.dense, rows, masks), labels)
                grads = torch.autograd.grad(loss, [*emb, *dense_params])
            g_emb = tree_like(dense, list(grads[: len(emb)]))
            return loss.detach(), (g_emb, list(grads[len(emb):]))

        return grad_fn

    def build_apply_fn(self):
        """The update after the sync: ``apply_fn(state, loss, grads, *, lr,
        noise=None, delta_grad=None, batch_rows=None) -> (state, metrics)``.

        Adam over the dense params (in place), then the method's
        ``dense_update`` of the table.  ``noise`` is the table's SR draw
        (``method.dense_noise``); ``delta_grad(w_new, step_vec, dense,
        gscale) -> g_step`` supplies the (synced) ALPT Delta gradient at the
        *updated* backbone ``dense``; ``batch_rows`` is the paper's b, the
        GLOBAL batch's table lookups, so the Delta gradient's scale does not
        change with the number of ranks."""
        spec, method = self.spec, self.method
        wd = self.cfg.emb_weight_decay

        def apply_fn(state: TrainState, loss, grads, *, lr, noise=None, delta_grad=None,
                     batch_rows=None):
            g_emb, g_dense = grads
            dense_params = list(state.dense.parameters())
            new_dense, dense_opt = adam_update(g_dense, state.dense_opt, dense_params, lr,
                                               use_kernel=spec.use_kernels)
            with torch.no_grad():
                for p, new in zip(dense_params, new_dense):
                    p.copy_(new)
            wrapped = None
            if delta_grad is not None:
                def wrapped(w_new, step_vec, gscale):  # line 4 at the UPDATED params
                    return delta_grad(w_new, step_vec, state.dense, gscale)

            emb_state, emb_opt, aux = method.dense_update(
                state.emb_state, state.emb_opt, g_emb, spec=spec, lr=lr, weight_decay=wd,
                noise=noise, delta_grad=wrapped, batch_rows=batch_rows)
            new_state = state._replace(emb_state=emb_state, step=state.step + 1,
                                       dense_opt=dense_opt, emb_opt=emb_opt)
            return new_state, {"loss": loss, "lr": lr, **aux}

        return apply_fn

    def build_delta_grad_fn(self):
        """ALPT's Delta gradient of one (micro)batch on the dense formulation:
        ``delta_fn(w_new, step_vec, dense, ids, labels, masks, gscale) ->
        g_step``; the rows are taken from the fake-quantized table with the
        occurrence-order transpose (``core.alpt.take_rows``)."""
        spec, method = self.spec, self.method
        wd = self.cfg.emb_weight_decay

        def delta_fn(w_new, step_vec, dense, ids, labels, masks, gscale):
            def loss_fn_q(table_q):
                rows = alpt_core.take_rows(table_q, ids.reshape(-1)).reshape(*ids.shape, -1)
                return ctr_models.bce_loss(ctr_models.logits_from_rows(dense, rows, masks),
                                           labels)

            return method.dense_delta_grad(w_new, step_vec, loss_fn_q, spec=spec,
                                           weight_decay=wd, gscale=gscale)

        return delta_fn

    def wrap_host_refresh(self, step_fn):
        """Host-side periodic refresh around a step function (prune's
        DeepLight mask): after each step the method's schedule clock is
        synced to the step count, and every ``refresh_every`` steps the
        state is refreshed."""
        spec, method = self.spec, self.method

        def step_with_refresh(state, ids, labels, **kw):
            state, m = step_fn(state, ids, labels, **kw)
            with tracer().span("train.refresh", step=state.step):
                emb_state = method.after_step(state.emb_state, state.step, spec)
            return state._replace(emb_state=emb_state), m

        return step_with_refresh

    @torch.no_grad()
    def _logits(self, state: TrainState, ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(ids, np.int32), device=self.device)
        rows = self.method.lookup(state.emb_state, ids, self.spec)
        return ctr_models.logits_from_rows(state.dense, rows)

    def evaluate(self, state: TrainState, batches) -> dict[str, float]:
        all_labels, all_probs = [], []
        for ids, labels in batches:
            all_probs.append(torch.sigmoid(self._logits(state, ids)).cpu().numpy())
            all_labels.append(labels)
        labels = np.concatenate(all_labels)
        probs = np.concatenate(all_probs)
        return {"auc": metrics.auc(labels, probs), "logloss": metrics.logloss(labels, probs)}

    def fit(self, data, *, steps: int, batch_size: int, state: TrainState | None = None,
            log=None):
        """Train ``steps`` batches of the ``train`` split -> ``(state, history)``.

        Starts from ``state`` (a fresh :meth:`init_state` by default) at its
        own step: batch ``i`` of the split trains step ``i``.  ``data`` is
        anything with ``batch(split, i, batch_size) -> (ids, labels)``.
        ``history`` holds one ``{"step", "loss", "ms"}`` per step; ``ms`` is
        the host clock around the step, ending when its loss reaches the
        host.  ``log`` is called with each entry.
        """
        state = self.init_state() if state is None else state
        history = []
        for _ in range(steps):
            ids, labels = data.batch("train", state.step, batch_size)
            t0 = time.perf_counter()
            state, m = self.train_step(state, ids, labels)
            loss = float(m["loss"])  # waits for the step
            history.append({"step": state.step, "loss": loss,
                            "ms": (time.perf_counter() - t0) * 1e3})
            if log:
                log(history[-1])
        return state, history


def clone_state(state: TrainState) -> TrainState:
    """A deep copy of ``state`` on its device (tables, params, optimizer
    slots and the generator's position) — train steps update in place."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(copy(v) for v in x)
        if hasattr(x, "_fields"):
            return type(x)(*(copy(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: copy(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x

    dense = type(state.dense)(state.dense.cfg, device=next(state.dense.parameters()).device)
    dense.load_state_dict(state.dense.state_dict())
    gen = None
    if state.generator is not None:
        gen = torch.Generator(device=state.generator.device)
        gen.set_state(state.generator.get_state())
    return state._replace(emb_state=copy(state.emb_state), dense=dense,
                          dense_opt=copy(state.dense_opt), emb_opt=copy(state.emb_opt),
                          generator=gen)
