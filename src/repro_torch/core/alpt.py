"""Adaptive low-precision training (ALPT) — paper §3.2, Algorithm 1 (port of
repro/core/alpt.py, the sparse CTR step).

Per batch, two alternating sub-steps:

  Step 1 (weights):   w_hat_b = Delta_b * w_tilde_b          (de-quantize)
                      w_b'    = w_hat_b - eta * df/dw_hat    (+ dense params)
  Step 2 (step size): Delta_b' = Delta_b - eta_D * df(Q_D(w_b', Delta_b))/dDelta
                      w_tilde_b' = SR-quantize(w_b', Delta_b')

The Delta gradient comes from an LSQ-style second forward pass over the
*updated float rows* (:func:`repro_torch.core.quant.fake_quant_lsq`, Eq. 6/7)
at the updated dense params, scaled by g = 1/sqrt(b * d * q) with
q = 2^{m-1} - 1.  The weight sub-step is :func:`repro_torch.core.lpt.sparse_apply`,
so ALPT is LPT plus the learned Delta.  The dense formulation
(``dense_weight_update`` / ``dense_delta_grad`` / ``dense_finish``) comes with
the dense/LM slice.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core import lpt, quant
from repro_torch.kernels import ops


class ALPTConfig(NamedTuple):
    bits: int = 8
    rounding: str = "sr"  # rounding for the write-back (paper: SR)
    optimizer: str = "adam"  # row optimizer for the embeddings
    weight_decay: float = 5e-8  # paper: 5e-8 Avazu / 1e-5 Criteo
    step_lr: float = 2e-5  # paper: Delta learning rate 2e-5
    step_weight_decay: float = 5e-8  # paper: same decay as embeddings (8-bit)
    grad_scale: str = "bdq"  # '1' | 'dq' | 'bdq'  (Fig. 4 sweep)
    use_kernels: bool = False
    # Absolute upper bound on the learned Delta; None leaves the update as
    # the paper's.  When set, clamped rows are counted in aux["delta_clamped"].
    step_clamp: float | None = None


def grad_scale_factor(cfg: ALPTConfig, batch_rows: int, dim: int) -> float:
    q = 2 ** (cfg.bits - 1) - 1
    if cfg.grad_scale == "1":
        return 1.0
    if cfg.grad_scale == "dq":
        return 1.0 / math.sqrt(dim * q)
    if cfg.grad_scale == "bdq":
        return 1.0 / math.sqrt(batch_rows * dim * q)
    raise ValueError(f"unknown grad_scale {cfg.grad_scale!r}")


class _TakeRows(torch.autograd.Function):
    """``rows[inv]`` whose backward is :func:`repro_torch.core.lpt.segment_sum`:
    the reference's transpose of ``take`` adds in occurrence order, and the
    default backward of ``index_select`` on the card uses atomics."""

    @staticmethod
    def forward(ctx, rows, inv):
        ctx.save_for_backward(inv)
        ctx.k = rows.shape[0]
        return rows.index_select(0, inv)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return lpt.segment_sum(g, inv, ctx.k), None


def alpt_step(table: lpt.LPTTable, ids: torch.Tensor, g_rows: torch.Tensor,
              loss_fn_step2: Callable[[torch.Tensor], torch.Tensor], *, cfg: ALPTConfig,
              lr: float, noise: tuple[torch.Tensor, torch.Tensor], id_space: int | None = None,
              out_dim: int | None = None):
    """One ALPT update of ``table``, **in place** -> ``(new_table, aux)``.

    ``g_rows`` [..., d_live] is df/drows at the batch's looked-up rows (the
    caller's one backward also gives the dense gradient, where the reference
    runs two).  ``loss_fn_step2(rows) -> scalar`` evaluates the loss at the
    *updated* dense params (Algorithm 1 line 4).  ``noise`` is the pair of
    SR draws [K, d], the port's ``sr_noise(kn)`` and
    ``sr_noise(fold_in(kn, 1))``: step 1's write-back and line 5's.
    ``id_space`` / ``out_dim`` carry the live geometry of ``pad_to_tiles``
    tables; the paper's b and d count live lookups, not padding.
    """
    d = table.dim
    d_live = d if out_dim is None else out_dim
    n = table.n_rows

    # ---- Step 1: float update of the batch's rows (+ codes, Adam slots). ----
    table1, (uniq, w_new, inv) = lpt.sparse_apply(
        table, ids, g_rows, lr=lr, bits=cfg.bits, rounding=cfg.rounding, noise=noise[0],
        optimizer=cfg.optimizer, weight_decay=cfg.weight_decay, return_updated_rows=True,
        id_space=id_space, use_kernels=cfg.use_kernels)

    # ---- Step 2: learn Delta on the *updated* float rows (line 4). ----
    safe = torch.clamp(uniq, max=n - 1).to(torch.int64)
    step_b = table1.step[safe]  # Delta_b^t (step 1 leaves Delta alone)
    gscale = grad_scale_factor(cfg, batch_rows=ids.numel(), dim=d_live)
    step_vec = step_b.clone().requires_grad_(True)
    with torch.enable_grad():
        rows_q = quant.fake_quant_lsq(w_new.detach(), step_vec, cfg.bits, gscale)
        occ = _TakeRows.apply(rows_q, inv).reshape(*ids.shape, d)
        if d_live != d:
            occ = occ[..., :d_live]
        (g_step,) = torch.autograd.grad(loss_fn_step2(occ), [step_vec])
    new_step_b = step_b - cfg.step_lr * (g_step + cfg.step_weight_decay * step_b)
    new_step_b = torch.clamp_min(new_step_b, 1e-8)  # Delta must stay positive
    aux = {"step_grad_norm": torch.linalg.vector_norm(g_step)}
    if cfg.step_clamp is not None:
        aux["delta_clamped"] = torch.sum(new_step_b > cfg.step_clamp)
        new_step_b = torch.clamp_max(new_step_b, cfg.step_clamp)
    aux["mean_step"] = torch.mean(new_step_b)

    # ---- Line 5: re-quantize w^{t+1} with the NEW Delta (SR). ----
    if cfg.use_kernels and cfg.rounding == "sr":
        codes_rows = ops.sr_round(w_new, new_step_b, noise[1], cfg.bits)
    else:
        if cfg.use_kernels:
            ops.note_fallback("sr_round", tuple(w_new.shape), "dr rounding")
        codes_rows = quant.quantize_codes(w_new, new_step_b, cfg.bits, cfg.rounding, noise[1])
    table1.codes.set_rows(uniq, codes_rows)
    lpt.set_rows(table1.step, uniq, new_step_b)
    return table1, aux
