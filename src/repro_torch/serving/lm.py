"""LM serving frontend: slot-based continuous-batch prefill / decode (port of
repro/serving/lm.py).

* one ``prefill`` per request at its exact length (batch 1), so its result
  does not depend on whatever else is in flight and a mamba layer's state
  sees no padding; its cache (attention's K/V ring, a mamba layer's conv
  windows and SSD state) is copied into a free slot whole (:func:`splice`);
* one ``decode_step`` over the fixed slot batch with a **per-slot**
  ``cache_len`` vector, so a freshly refilled slot decodes next to slots deep
  into generation; the cache is updated in place;
* finished slots are refilled from the queue immediately — no wave barrier.

Per-request determinism (the slot-refill contract): every per-row op of the
decode step is independent of the other rows — the cuBLAS projections run at
the one fixed slot batch, decode attention and the SSM step are per row, MoE
routing and capacity are per sample, and the head kernel sums each logit in
a fixed order whatever the batch — and prefill is per
request, so a request's tokens are bitwise identical whatever the arrival
order or slot.

A ``mixed``-input arch (the VLM) serves its text path: prompts of tokens,
three equal M-RoPE position streams; an ``embeds`` arch (encoder-only) has
no decode path and is refused, as in the reference.

The embedding table stays int8-resident end to end: token rows read through
``ops.dequant_gather``, a tied head contracts through
``ops.dequant_matmul``, prefill attention runs ``ops.flash_attention_fwd``
(``spec.use_kernels=False`` asks for the plain versions of all three).
Each prefill is one ``engine.prefill`` span and each decode step one
``engine.decode`` span, fenced on their logits while tracing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import methods
from repro_torch.checkpoint import manager as ckpt
from repro_torch.models import transformer as tfm
from repro_torch.obs.trace import tracer
from repro_torch.serving.engine import Engine
from repro_torch.training import lm_trainer


@dataclasses.dataclass(frozen=True)
class LMRequest:
    prompt: np.ndarray  # [T] int32 token ids
    max_new: int
    rid: int | None = None


def splice(cache: list, cache_one: list, slot: int) -> None:
    """Copy a batch-1 prefilled cache into batch slot ``slot`` of ``cache``,
    in place: every leaf of every period position's entry (laid out
    ``[n_groups, batch, ...]``), so a refilled slot keeps nothing of its
    previous request."""
    for full, one in zip(cache, cache_one):
        for key, leaf in full.items():
            leaf[:, slot] = one[key][:, 0]


class LMEngine(Engine):
    scenario = "lm"

    def __init__(self, params, serving_table, cfg: tfm.ModelConfig,
                 spec: methods.EmbeddingSpec, *, batch: int, max_len: int):
        if cfg.input_mode == "embeds":
            raise ValueError(f"{cfg.name}: encoder-only archs have no decode path")
        tfm.check_supported(cfg)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        super().__init__(serving_table=serving_table, spec=spec)
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.device = serving_table.tensors()[0].device
        self.use_kernels = spec.use_kernels
        # Device state: the slot cache; host state: per-slot token / length.
        self._cache = tfm.init_cache(cfg, batch, max_len, device=self.device)
        self._cur = np.zeros((batch,), np.int32)
        self._cache_len = np.zeros((batch,), np.int32)
        self._slot_rid: list[int | None] = [None] * batch
        self._slot_budget = [0] * batch
        self._slot_out: list[list[int]] = [[] for _ in range(batch)]

    @classmethod
    def from_state(cls, state, cfg: tfm.ModelConfig, tcfg=None, *, batch: int,
                   max_len: int) -> "LMEngine":
        """Build from an ``lm_trainer.LMTrainState`` (params + table state)."""
        spec = lm_trainer.embedding_spec_of(cfg, tcfg)
        table = cls.build_serving_state(state.table, spec)
        return cls(state.params, table, cfg, spec, batch=batch, max_len=max_len)

    @classmethod
    def from_checkpoint(cls, directory, cfg: tfm.ModelConfig, tcfg=None, *, batch: int,
                        max_len: int, step: int | None = None,
                        device: str | torch.device = "cuda") -> "LMEngine":
        """Restore params + table from a serving checkpoint
        (``checkpoint.save_serving_checkpoint``) onto ``device``: the artifact
        holds the serving-resident table itself, so codes restore as codes
        and go straight into residency, with no fp32 table and no training
        leaf on the way."""
        dev = device_mod.resolve(device)
        spec = lm_trainer.embedding_spec_of(cfg, tcfg)
        params, table, _ = ckpt.restore_serving_checkpoint(directory, spec, step=step,
                                                           device=dev)
        params = tfm.params_from_numpy(cfg, params, device=dev)
        return cls(params, table, cfg, spec, batch=batch, max_len=max_len)

    # ------------------------------------------------------------ scheduler

    def submit(self, request: LMRequest) -> int:
        prompt = np.asarray(request.prompt)
        if len(prompt) + request.max_new > self.max_len + 1:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {request.max_new} "
                f"exceeds engine max_len {self.max_len}"
            )
        # The reference's gather clamps; a hand-written gather must never be
        # handed a row outside the table.
        vocab = self.table.live_rows()
        if prompt.size and (prompt.min() < 0 or prompt.max() >= vocab):
            raise ValueError(f"prompt tokens must lie in [0, {vocab}); got "
                             f"[{prompt.min()}, {prompt.max()}]")
        # A mamba layer's chunked SSD takes a prompt of at most one chunk or a
        # multiple of it (the reference's engine raises at prefill instead).
        tfm.check_prompt_len(self.cfg, len(prompt))
        return super().submit(request)

    def _has_work(self) -> bool:
        return bool(self._queue) or any(rid is not None for rid in self._slot_rid)

    def _free_slots(self) -> list[int]:
        return [i for i, rid in enumerate(self._slot_rid) if rid is None]

    def _prefill(self, req: LMRequest):
        """Exact-length batch-1 prefill -> ``(logits [1, V], cache)``."""
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32), device=self.device)
        return tfm.prefill(self.params, self.table, prompt[None, :], self.cfg, self.max_len,
                           use_kernel=self.use_kernels)

    def _decode(self) -> torch.Tensor:
        """One decode step over every slot -> logits [batch, V]."""
        logits, self._cache = tfm.decode_step(
            self.params, self.table, torch.as_tensor(self._cur, device=self.device),
            self._cache, torch.as_tensor(self._cache_len, device=self.device), self.cfg,
            use_kernel=self.use_kernels)
        return logits

    def _admit(self) -> None:
        """Refill free slots from the queue: per-request exact-length prefill,
        its cache copied into the slot."""
        free = self._free_slots()
        while free and self._queue:
            req = self._queue.popleft()
            if req.max_new <= 0:
                self._finish(req.rid, [])  # zero generation budget
                continue
            with tracer().span("engine.prefill", rid=req.rid, prompt_len=len(req.prompt)):
                with torch.inference_mode():
                    logits, cache_one = self._prefill(req)
                tracer().fence(logits)
            first = int(torch.argmax(logits[0]))
            self._tokens += 1
            if req.max_new <= 1:
                self._finish(req.rid, [first])  # done at prefill; no slot used
                continue
            slot = free.pop(0)
            splice(self._cache, cache_one, slot)
            self._slot_rid[slot] = req.rid
            self._slot_budget[slot] = req.max_new
            self._slot_out[slot] = [first]
            self._cur[slot] = first
            self._cache_len[slot] = len(req.prompt)

    def _advance(self) -> None:
        self._admit()
        active = [i for i, rid in enumerate(self._slot_rid) if rid is not None]
        if not active:
            return
        with tracer().span("engine.decode", active=len(active)):
            with torch.inference_mode():
                logits = self._decode()
            tracer().fence(logits)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self._cache_len += 1
        for slot in active:
            self._cur[slot] = nxt[slot]
            self._slot_out[slot].append(int(nxt[slot]))
            self._tokens += 1
            if len(self._slot_out[slot]) >= self._slot_budget[slot]:
                self._finish(self._slot_rid[slot], self._slot_out[slot])
                self._slot_rid[slot] = None
                self._slot_out[slot] = []
