"""CTR serving frontend: batched request scoring at fixed geometry (port of
repro/serving/ctr.py).

Requests (one [n_fields] vector of global feature ids each) are admitted in
waves of up to ``batch`` and padded to the fixed [batch, n_fields] geometry;
pad rows repeat the wave's first request and their outputs are discarded.
Each wave reads its rows straight off the resident table (integer codes
through ``ops.dequant_gather``, per sub-table for the composed methods; the
fp32 export of float-leaf methods) and runs the backbone's forward (DCN or
DeepFM), then the sigmoid.  Scores are per-row independent, so a request's
result does not depend on the wave it lands in.  ``from_checkpoint`` serves
a serving checkpoint.  Hot/cold tiers come later.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import methods
from repro_torch.checkpoint import manager as ckpt
from repro_torch.models import ctr as ctr_models
from repro_torch.serving import table as serving_tbl
from repro_torch.serving.engine import Engine


@dataclasses.dataclass(frozen=True)
class CTRRequest:
    ids: np.ndarray  # [n_fields] int32 global feature ids
    rid: int | None = None


class CTREngine(Engine):
    scenario = "ctr"

    def __init__(self, dense: torch.nn.Module, serving_table: serving_tbl.ServingTable,
                 model_cfg, spec: methods.EmbeddingSpec, *, batch: int):
        super().__init__(serving_table=serving_table, spec=spec)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.dense = dense.eval()
        self.model_cfg = model_cfg
        self.batch = batch
        self.n_fields = model_cfg.n_fields
        self.n_rows = serving_table.live_rows()
        self.device = serving_table.tensors()[0].device
        dense_device = next(dense.parameters()).device
        if dense_device != self.device:
            raise ValueError(f"dense params on {dense_device}, table on {self.device}")

    @classmethod
    def from_state(cls, state, cfg, *, batch: int) -> "CTREngine":
        """Build from a ``training.ctr_trainer.TrainState`` + its ``TrainerConfig``."""
        table = cls.build_serving_state(state.emb_state, cfg.spec)
        return cls(state.dense, table, cfg.model_cfg, cfg.spec, batch=batch)

    @classmethod
    def from_checkpoint(cls, directory, cfg, *, batch: int, step: int | None = None,
                        device: str | torch.device = "cuda") -> "CTREngine":
        """Build from a serving checkpoint (``checkpoint.save_serving_checkpoint``
        of the backbone's ``param_tree()`` and the table): the backbone from
        ``cfg``, its params and the serving-resident table restored onto
        ``device``; codes restore as codes, straight into residency."""
        dev = device_mod.resolve(device)
        params, table, _ = ckpt.restore_serving_checkpoint(directory, cfg.spec, step=step,
                                                           device=dev)
        dense = ctr_models.MODELS[cfg.model][1](cfg.model_cfg, device=dev)
        return cls(dense.load_jax_params(params), table, cfg.model_cfg, cfg.spec, batch=batch)

    def submit(self, request: CTRRequest) -> int:
        ids = np.asarray(request.ids)
        if ids.shape != (self.n_fields,):
            raise ValueError(f"request ids shape {ids.shape} != ({self.n_fields},)")
        # The reference checks the shape only (its gather clamps or fills);
        # a hand-written gather must never be handed a row outside the table.
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_rows):
            raise ValueError(
                f"request ids must lie in [0, {self.n_rows}); got "
                f"[{ids.min()}, {ids.max()}]"
            )
        return super().submit(request)

    def _padded_wave_ids(self, reqs) -> np.ndarray:
        ids = np.zeros((self.batch, self.n_fields), np.int32)
        for i, req in enumerate(reqs):
            ids[i] = req.ids
        # Pad rows repeat request 0 (always in range); outputs discarded.
        ids[len(reqs):] = ids[0]
        return ids

    def _advance(self) -> None:
        wave = [self._queue.popleft() for _ in range(min(self.batch, len(self._queue)))]
        ids = torch.from_numpy(self._padded_wave_ids(wave)).to(self.device)
        with torch.inference_mode():
            rows = self.table.rows(ids)
            logits = ctr_models.logits_from_rows(self.dense, rows)
            probs = torch.sigmoid(logits)
        logits = logits.cpu().tolist()
        probs = probs.cpu().tolist()
        for i, req in enumerate(wave):
            self._finish(req.rid, {"logit": logits[i], "prob": probs[i]})
