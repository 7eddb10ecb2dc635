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
q = 2^{m-1} - 1.  The weight sub-step is :func:`repro_torch.core.lpt.sparse_apply`
(the CTR path) or the dense float update of :func:`dense_weight_update` (the
LM path), so ALPT is LPT plus the learned Delta.  The dense formulation is
split as the reference's (:func:`dense_weight_update` /
:func:`dense_delta_grad` / :func:`dense_finish`, composed by
:func:`alpt_dense_step`).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core import lpt, quant
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels import ops, ref


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


def take_rows(rows: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``rows[inv]`` (int64 ``inv``), its backward the occurrence-order
    :func:`repro_torch.core.lpt.segment_sum`."""
    return _TakeRows.apply(rows, inv.to(torch.int64))


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
        occ = take_rows(rows_q, inv).reshape(*ids.shape, d)
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


class DenseWeightUpdate(NamedTuple):
    """Intermediate of the dense weight sub-step (Algorithm 1 lines 1-3),
    handed from :func:`dense_weight_update` to :func:`dense_finish`."""

    w_new: torch.Tensor  # f32 [n, d] float-updated rows
    mu_new: torch.Tensor
    nu_new: torch.Tensor
    touched: torch.Tensor  # bool [n]
    count: int


def dense_weight_update(table: lpt.LPTTable, grad_table: torch.Tensor, *, cfg: ALPTConfig,
                        lr: float) -> DenseWeightUpdate:
    """Dense float weight update (Algorithm 1 line 2) without the write-back:
    the whole table de-quantized and stepped by the row optimizer."""
    touched = tp.rows_any(torch.any(grad_table != 0.0, dim=-1))
    count = table.count + 1
    w_new, mu_new, nu_new = lpt._row_update(
        table.codes.unpack().to(torch.float32), table.step, grad_table.to(torch.float32),
        table.mu, table.nu, count, lr, cfg.optimizer, cfg.weight_decay)
    return DenseWeightUpdate(w_new=w_new, mu_new=mu_new, nu_new=nu_new, touched=touched,
                             count=count)


def dense_delta_grad(w_new: torch.Tensor, step_vec: torch.Tensor,
                     loss_fn_q: Callable[[torch.Tensor], torch.Tensor], *, cfg: ALPTConfig,
                     gscale: float) -> torch.Tensor:
    """Delta gradient (Algorithm 1 line 4): ``loss_fn_q`` of the fake-quantized
    *updated* table differentiated w.r.t. the step vector [n] (Eq. 7 through
    :func:`repro_torch.core.quant.fake_quant_lsq`).  A loss that does not read
    the table (an encoder's, from its frames) gives the zero gradient that
    ``jax.grad`` gives.  A table sharded over d (``StepLayout.width_split``)
    sums each row's partial gradient over the model ranks."""
    step_vec = step_vec.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        table_q = quant.fake_quant_lsq(w_new.detach(), step_vec, cfg.bits, gscale)
        (g_step,) = grads_or_zeros(loss_fn_q(table_q), [step_vec])
    return tp.rows_sum(g_step)


def grads_or_zeros(loss: torch.Tensor, inputs: list) -> list:
    """``torch.autograd.grad(loss, inputs)`` with ``jax.grad``'s zeros for an
    input the loss does not read (where ``torch.autograd.grad`` raises)."""
    if not loss.requires_grad:
        return [torch.zeros_like(x.detach()) for x in inputs]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [torch.zeros_like(x.detach()) if g is None else g for x, g in zip(inputs, grads)]


def delta_step(step: torch.Tensor, g_step: torch.Tensor, cfg: ALPTConfig) -> torch.Tensor:
    """The Delta update ``max(step - lr_D * (g + wd_D * step), 1e-8)`` as
    XLA:CPU compiles the reference's, two fused multiply-adds:
    ``fma(-lr_D, fma(wd_D, step, g), step)``."""
    inner = ref.fma(ref.f32(cfg.step_weight_decay), step, g_step.to(torch.float32))
    return torch.clamp_min(ref.fma(-ref.f32(cfg.step_lr), inner, step), 1e-8)


def dense_finish(table: lpt.LPTTable, upd: DenseWeightUpdate, g_step: torch.Tensor, *,
                 cfg: ALPTConfig, noise: torch.Tensor) -> lpt.LPTTable:
    """Delta update + SR re-quantization (Algorithm 1 line 5), touched-row
    masked so untouched rows keep codes, Delta and slots bit-identical.
    ``noise`` f32 [n, d] is the reference's ``sr_noise(fold_in(kn, 1), (n, d))``.
    With ``cfg.use_kernels`` and SR the write-back is ``ops.sr_round`` (f32 in,
    codes out); DR takes the plain quantizer, counted as a fallback.
    The Delta step is :func:`delta_step`.
    """
    new_step = delta_step(table.step, g_step, cfg)
    if cfg.step_clamp is not None:
        new_step = torch.clamp_max(new_step, cfg.step_clamp)
    new_step = torch.where(upd.touched, new_step, table.step)
    if cfg.use_kernels and cfg.rounding == "sr":
        codes_new = ops.sr_round(upd.w_new, new_step, noise, cfg.bits)
    else:
        if cfg.use_kernels:
            ops.note_fallback("sr_round", tuple(upd.w_new.shape), "dr rounding")
        codes_new = quant.quantize_codes(upd.w_new, new_step, cfg.bits, cfg.rounding, noise)
    slot_mask = upd.touched[:, None] if table.mu.ndim == 2 else upd.touched
    return table._replace(codes=table.codes.where_rows(upd.touched, codes_new), step=new_step,
                          mu=torch.where(slot_mask, upd.mu_new, table.mu),
                          nu=torch.where(slot_mask, upd.nu_new, table.nu), count=upd.count)


def alpt_dense_step(table: lpt.LPTTable, grad_table: torch.Tensor,
                    loss_fn_q: Callable[[torch.Tensor], torch.Tensor], *, cfg: ALPTConfig,
                    lr: float, noise: torch.Tensor, batch_rows: int) -> lpt.LPTTable:
    """Dense ALPT step: :func:`dense_weight_update`, then the Delta gradient of
    ``loss_fn_q(table_fp) -> scalar`` at the updated rows, then
    :func:`dense_finish`.  ``batch_rows`` is the paper's b, the table-row
    lookups of the batch (its token count for an LM), in the gradient scale
    g = 1/sqrt(b*d*q)."""
    upd = dense_weight_update(table, grad_table, cfg=cfg, lr=lr)
    gscale = grad_scale_factor(cfg, batch_rows=int(batch_rows), dim=table.dim)
    g_step = dense_delta_grad(upd.w_new, table.step, loss_fn_q, cfg=cfg, gscale=gscale)
    return dense_finish(table, upd, g_step, cfg=cfg, noise=noise)
