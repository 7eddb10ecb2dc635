"""End-to-end CTR training for fp, lpt and alpt on DCN (port of
repro/training/ctr_trainer.py).

One trainer, any ported method; the trainer never names a method.  It keys
off two capability surfaces:

  float-leaf methods    : joint Adam over (embedding leaves, dense params)
  integer-table methods : the method's ``fused_row_step`` (Eq. 8 for LPT,
                          Algorithm 1 for ALPT)

The paper's protocol (§4.1): Adam lr 1e-3, tenfold decay boundaries,
decoupled weight decay on embeddings, Delta lr 2e-5.  Every SR draw comes
from the state's ``torch.Generator``; :meth:`CTRTrainer.train_step` takes
``noise=`` so a test can hand in the reference's draws instead.  The hot-row
cache, the non-finite guard, DeepFM, dropout and the data-parallel hooks are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import methods, metrics
from repro_torch.core import quant
from repro_torch.models import ctr as ctr_models
from repro_torch.optim import OptState, adam_init, adam_update


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    spec: methods.EmbeddingSpec
    dcn: ctr_models.DCNConfig
    seed: int = 0
    lr: float = 1e-3
    emb_weight_decay: float = 5e-8
    lr_boundaries: tuple[int, ...] = ()  # steps at which lr /= 10


class TrainState(NamedTuple):
    emb_state: Any  # the method's table state (an LPTTable for lpt/alpt)
    dense: ctr_models.DCN
    step: int
    dense_opt: OptState | None = None  # Adam over dense.parameters()
    emb_opt: OptState | None = None  # Adam over float embedding leaves (fp)
    generator: torch.Generator | None = None  # SR noise of the train steps


def init_state(cfg: TrainerConfig, *, device: str | torch.device = "cuda") -> TrainState:
    """Embedding table then DCN params, both drawn from one generator seeded
    with ``cfg.seed`` on ``device`` (``cuda`` unless the caller asks for the
    CPU; raises if CUDA is asked for and absent).  The same generator then
    draws the training steps' SR noise."""
    dev = device_mod.resolve(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.seed)
    method = methods.get(cfg.spec.method)
    emb_state = method.init(generator, cfg.spec)
    dense = ctr_models.init_dcn(cfg.dcn, generator)
    emb_params = method.trainable_params(emb_state, cfg.spec)
    return TrainState(
        emb_state=emb_state, dense=dense, step=0,
        dense_opt=adam_init(list(dense.parameters())),
        emb_opt=None if emb_params is None else adam_init([emb_params]),
        generator=generator,
    )


class CTRTrainer:
    def __init__(self, cfg: TrainerConfig, *, device: str | torch.device = "cuda"):
        if cfg.dcn.dropout:
            raise NotImplementedError("dropout in training is not ported yet")
        self.cfg = cfg
        self.spec = cfg.spec
        self.method = methods.get(cfg.spec.method)
        self.device = device_mod.resolve(device)

    def init_state(self) -> TrainState:
        return init_state(self.cfg, device=self.device)

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

    def train_step(self, state: TrainState, ids, labels, *, noise=None):
        """One step on a batch (ids int32 [B, F], labels [B]) -> ``(state, metrics)``.

        Integer tables are updated in place; the returned state shares their
        tensors.  ``noise`` overrides the generator's SR draws: a sequence of
        ``method.noise_draws`` tensors [B*F, d_alloc].
        """
        lr = self._lr_at(state.step)
        ids, labels = self._batch(ids, labels)
        dense = state.dense
        dense_params = list(dense.parameters())

        def loss_from_rows(rows):
            return ctr_models.bce_loss(ctr_models.logits_from_rows(dense, rows), labels)

        if not self.method.is_integer_table:
            return self._float_leaf_step(state, ids, lr, loss_from_rows, dense_params)

        if noise is None:
            shape = (ids.numel(), self.spec.d_padded)
            noise = [quant.sr_noise(state.generator, shape) for _ in range(self.method.noise_draws)]
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
        spec, method = self.spec, self.method
        emb = method.trainable_params(state.emb_state, spec).detach().requires_grad_(True)
        with torch.enable_grad():
            rows = method.lookup(method.with_params(state.emb_state, emb, spec), ids, spec)
            loss = loss_from_rows(rows)
            g_emb, *g_dense = torch.autograd.grad(loss, [emb, *dense_params])
        new_dense, dense_opt = adam_update(g_dense, state.dense_opt, dense_params, lr,
                                           use_kernel=spec.use_kernels)
        (new_emb,), emb_opt = adam_update([g_emb], state.emb_opt, [emb.detach()], lr,
                                          weight_decay=self.cfg.emb_weight_decay,
                                          use_kernel=spec.use_kernels)
        with torch.no_grad():
            for p, new in zip(dense_params, new_dense):
                p.copy_(new)
        new_state = state._replace(emb_state=method.with_params(state.emb_state, new_emb, spec),
                                   step=state.step + 1, dense_opt=dense_opt, emb_opt=emb_opt)
        return new_state, {"loss": loss.detach(), "lr": lr}

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

    dense = ctr_models.DCN(state.dense.cfg, device=next(state.dense.parameters()).device)
    dense.load_state_dict(state.dense.state_dict())
    gen = None
    if state.generator is not None:
        gen = torch.Generator(device=state.generator.device)
        gen.set_state(state.generator.get_state())
    return state._replace(emb_state=copy(state.emb_state), dense=dense,
                          dense_opt=copy(state.dense_opt), emb_opt=copy(state.emb_opt),
                          generator=gen)
