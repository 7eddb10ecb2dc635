"""qr_lpt / qr_alpt: quotient-remainder hashing composed with LPT tables (port
of repro/methods/qr_lpt.py).

Both QR sub-tables (Shi et al. 2020) live as integer codes + per-row Delta
with no fp32 master copy (paper Eq. 8 per sub-table), so the compression
ratios multiply: ~2x from hashing times ~4x from 8-bit codes.  Row
gradients reach each sub-table through the product rule, d(rem * quo)/drem
= quo and vice versa.  Each sub-table's lookups and row steps take the same
kernels as plain LPT (``dequant_gather``, ``sparse_row_update_runs``), each
with its own dedup sentinel / scratch row under ``spec.pad_to_tiles``;
qr_alpt's line-5 re-quantize takes ``sr_round``.

SR draws, in order: the CTR step's remainder and quotient row steps, then
(qr_alpt) the remainder's and the quotient's Delta write-backs, each [K, d]
(the reference's ``fold_in(nk, 0)``, ``fold_in(nk, 1)``,
``fold_in(fold_in(nk, 0), 1)``, ``fold_in(fold_in(nk, 1), 1)``); the dense
(LM) step's remainder and quotient draws at their allocated shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import alpt as alpt_core
from repro_torch.core import hashing
from repro_torch.core import lpt as lpt_core
from repro_torch.core import quant
from repro_torch.dist.sharding import P
from repro_torch.kernels import ops
from repro_torch.methods.base import TILE, IntegerTableMethod, _round_up, pad_grads, register
from repro_torch.serving import table as serving_tbl
from repro_torch.storage.base import CacheSlot


class QRLPTTable(NamedTuple):
    remainder: lpt_core.LPTTable  # [r, d] sub-table (+ scratch row if padded)
    quotient: lpt_core.LPTTable  # [ceil(n/r), d] sub-table
    r: int  # remainder modulus


def _pad_rows(rows: int, spec) -> int:
    """Sub-table allocation: id space + scratch row, TILE-rounded if padded."""
    return _round_up(rows + 1, TILE) if spec.pad_to_tiles else rows


def _split(state: QRLPTTable, ids: torch.Tensor):
    return ids % state.r, torch.div(ids, state.r, rounding_mode="floor")


@register("qr_lpt")
class QRLPTMethod(IntegerTableMethod):
    def noise_draws(self, spec):
        return 2

    def table_pspec(self, row, col, *, row_optimizer="adam"):
        # Sub-table row counts rarely divide the mesh axes; stay replicated.
        sub = lpt_core.LPTTable(codes=P(), step=P(), mu=P(), nu=P(), count=P())
        return QRLPTTable(remainder=sub, quotient=sub, r=P())

    def sparse_noise(self, noise):
        return list(noise)

    def init(self, generator, spec):
        r, q_rows = hashing.qr_rows(spec.n, spec.hash_compression)
        kw = dict(init_scale=spec.init_scale, optimizer=spec.row_optimizer,
                  use_kernels=spec.use_kernels, packed=spec.packed)
        rem = lpt_core.init_table(generator, _pad_rows(r, spec), spec.d_padded, spec.bits, **kw)
        # The quotient factor starts near 1, so the product starts ~= the
        # remainder rows (Shi et al. 2020).
        quo = lpt_core.init_table(generator, _pad_rows(q_rows, spec), spec.d_padded, spec.bits,
                                  mean=1.0, **kw)
        return QRLPTTable(remainder=rem, quotient=quo, r=r)

    def _factors(self, state, rid, qid, spec):
        kw = dict(use_kernels=spec.use_kernels, out_dim=spec.d)
        return (lpt_core.lookup(state.remainder, rid, **kw),
                lpt_core.lookup(state.quotient, qid, **kw))

    def lookup(self, state, ids, spec, grad_scale=1.0):
        rem, quo = self._factors(state, *_split(state, ids), spec)
        return rem * quo

    def dense_table(self, state, spec):
        return self.lookup(state, torch.arange(spec.n, dtype=torch.int32,
                                               device=state.remainder.step.device), spec)

    def checkpoint_schema(self, spec):
        r, q_rows = hashing.qr_rows(spec.n, spec.hash_compression)
        kw = dict(optimizer=spec.row_optimizer, packed=spec.packed)
        return {**lpt_core.schema(_pad_rows(r, spec), spec.d_padded, spec.bits,
                                  prefix=".remainder", **kw),
                **lpt_core.schema(_pad_rows(q_rows, spec), spec.d_padded, spec.bits,
                                  prefix=".quotient", **kw),
                ".r": {"shape": [], "dtype": "int32"}}

    def memory_bytes(self, state, spec, *, training=True, stored=False):
        # Container-actual codes of both sub-tables + their per-row Delta
        # (+ their row-optimizer slots).
        return sum(lpt_core.memory_bytes(t, spec.bits, count_optimizer=stored and training)
                   for t in (state.remainder, state.quotient))

    def storage_spec(self, spec):
        """Two slots, each sub-table cached on its own; global ids reach a
        sub-table by the lookups' ``% r`` / ``// r``."""
        r, q_rows = hashing.qr_rows(spec.n, spec.hash_compression)
        return (
            CacheSlot(name="remainder", rows=r, get=lambda s: s.remainder,
                      put=lambda s, t: s._replace(remainder=t),
                      local_ids=lambda ids: np.asarray(ids) % r),
            CacheSlot(name="quotient", rows=q_rows, get=lambda s: s.quotient,
                      put=lambda s, t: s._replace(quotient=t),
                      local_ids=lambda ids: np.asarray(ids) // r),
        )

    def _sub_kw(self, spec, lr, weight_decay):
        return dict(lr=lr, bits=spec.bits, rounding=spec.alpt.rounding,
                    optimizer=spec.row_optimizer, weight_decay=weight_decay,
                    use_kernels=spec.use_kernels)

    def _weight_step(self, state, rid, qid, rem, quo, g_rows, *, spec, lr, weight_decay,
                     noise, keep_rows=False):
        """Both sub-tables' row steps from the factors ``rem``/``quo`` the
        step already gathered; ``keep_rows`` also returns each one's
        ``(uniq, w_new, inv)`` for the Delta sub-step."""
        r, q_rows = hashing.qr_rows(spec.n, spec.hash_compression)
        kw = dict(self._sub_kw(spec, lr, weight_decay), return_updated_rows=keep_rows)
        # Product rule: each sub-table's row cotangent is g * (other factor).
        return (lpt_core.sparse_apply(state.remainder, rid, g_rows * quo, noise=noise[0],
                                      id_space=r, **kw),
                lpt_core.sparse_apply(state.quotient, qid, g_rows * rem, noise=noise[1],
                                      id_space=q_rows, **kw))

    def sparse_apply(self, state, ids, g_rows, *, spec, lr, weight_decay, noise):
        rid, qid = _split(state, ids)
        rem, quo = self._factors(state, rid, qid, spec)
        subs = self._weight_step(state, rid, qid, rem, quo, g_rows, spec=spec, lr=lr,
                                 weight_decay=weight_decay, noise=noise)
        return QRLPTTable(*subs, r=state.r)

    def fused_row_step(self, state, ids, *, spec, loss_from_rows, dense_params,
                       update_dense, lr, weight_decay, noise):
        """One gather of each factor serves the backward at the product rows
        and both row steps; qr_alpt then learns both Deltas (line 4-5)."""
        rid, qid = _split(state, ids)
        rem, quo = self._factors(state, rid, qid, spec)
        rows = (rem * quo).detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_from_rows(rows)
            g_rows, *g_dense = torch.autograd.grad(loss, [rows, *dense_params])
        update_dense(g_dense)
        subs = self._weight_step(state, rid, qid, rem, quo, g_rows, spec=spec, lr=lr,
                                 weight_decay=weight_decay, noise=noise,
                                 keep_rows=self.has_learned_step)
        if not self.has_learned_step:
            return QRLPTTable(*subs, r=state.r), {"loss": loss.detach()}
        new_state, aux = self._learn_steps(state, ids, subs, spec=spec,
                                           loss_from_rows=loss_from_rows,
                                           weight_decay=weight_decay, noise=noise[2:])
        return new_state, {"loss": loss.detach(), **aux}

    def _dense_grads(self, state, grads, spec):
        """The virtual [n, d] table's gradient, segment-summed into each
        sub-table (occurrence order) and padded to its allocation."""
        ids = torch.arange(spec.n, dtype=torch.int32, device=grads.device)
        rid, qid = _split(state, ids)
        rem, quo = self._factors(state, rid, qid, spec)
        g_rem = lpt_core.segment_sum(grads * quo, rid.to(torch.int64), state.remainder.n_rows)
        g_quo = lpt_core.segment_sum(grads * rem, qid.to(torch.int64), state.quotient.n_rows)
        return pad_grads(g_rem, state.remainder), pad_grads(g_quo, state.quotient)

    def dense_noise(self, generator, state, spec):
        return [quant.sr_noise(generator, tuple(t.codes.shape))
                for t in (state.remainder, state.quotient)]

    def dense_update(self, state, opt, grads, *, spec, lr, weight_decay, noise=None,
                     delta_grad=None, batch_rows=None):
        """The dense (LM) formulation: ``grads`` is the [n, d] gradient of
        the virtual product table; each sub-table takes ``lpt.dense_apply``
        of its segment sum."""
        g_rem, g_quo = self._dense_grads(state, grads, spec)
        kw = self._sub_kw(spec, lr, weight_decay)
        new_rem = lpt_core.dense_apply(state.remainder, g_rem, noise=noise[0], **kw)
        new_quo = lpt_core.dense_apply(state.quotient, g_quo, noise=noise[1], **kw)
        return QRLPTTable(remainder=new_rem, quotient=new_quo, r=state.r), None, {}

    def serving_state(self, state, spec):
        """Integer-resident composition: both sub-tables ship their codes and
        their own per-row Delta (qr_alpt learns both)."""
        r, q_rows = hashing.qr_rows(spec.n, spec.hash_compression)

        def sub(table, live_rows):
            return serving_tbl.QuantTable(codes=table.codes, step=table.step, n=live_rows,
                                          d=spec.d, use_kernels=spec.use_kernels)

        return serving_tbl.QRQuantTable(remainder=sub(state.remainder, r),
                                        quotient=sub(state.quotient, q_rows), r=r, n=spec.n,
                                        d=spec.d)


@register("qr_alpt")
class QRALPTMethod(QRLPTMethod):
    """qr_lpt with ALPT's learned step size on both sub-tables: each keeps its
    own per-row Delta, learned by the LSQ-style second forward (Algorithm 1
    line 4) through the composed product, so d(loss)/d(Delta_rem) sees the
    quotient factor and vice versa.  The weight sub-step is qr_lpt's."""

    has_learned_step = True

    def noise_draws(self, spec):
        return 4

    @staticmethod
    def _acfg(spec, weight_decay) -> alpt_core.ALPTConfig:
        # As alpt's: spec.bits sized both code containers, so the LSQ clip,
        # the grad scale and line 5's re-quantize take it.  The reference's
        # qr_alpt keeps spec.alpt.bits (8) here, which at 4 or 2 bits writes
        # 8-bit codes into the narrower containers (ROADMAP, Queue C).
        return spec.alpt._replace(bits=spec.bits, weight_decay=weight_decay,
                                  optimizer=spec.row_optimizer, use_kernels=spec.use_kernels)

    def _delta_writeback(self, table, uniq, w_new, step_b, g_step, *, cfg, noise):
        """Algorithm 1 line 5 for one sub-table, in place: the Delta update,
        then the SR re-quantize of the float-updated unique rows."""
        new_step_b = alpt_core.delta_step(step_b, g_step, cfg)
        if cfg.use_kernels and cfg.rounding == "sr":
            codes_rows = ops.sr_round(w_new, new_step_b, noise, cfg.bits)
        else:
            if cfg.use_kernels:
                ops.note_fallback("sr_round", tuple(w_new.shape), "dr rounding")
            codes_rows = quant.quantize_codes(w_new, new_step_b, cfg.bits, cfg.rounding, noise)
        table.codes.set_rows(uniq, codes_rows)
        lpt_core.set_rows(table.step, uniq, new_step_b)
        return table

    def _learn_steps(self, state, ids, subs, *, spec, loss_from_rows, weight_decay, noise):
        """Both step vectors jointly (line 4), at the updated dense params,
        through the fake-quantized product of the updated rows; then each
        sub-table's line-5 write-back, with ``noise`` = its two draws."""
        cfg = self._acfg(spec, weight_decay)
        (rem1, (uniq_r, w_new_r, inv_r)), (quo1, (uniq_q, w_new_q, inv_q)) = subs
        d = state.remainder.dim
        step_r = rem1.step[torch.clamp(uniq_r, max=rem1.n_rows - 1).to(torch.int64)]
        step_q = quo1.step[torch.clamp(uniq_q, max=quo1.n_rows - 1).to(torch.int64)]
        gscale = alpt_core.grad_scale_factor(cfg, batch_rows=ids.numel(), dim=spec.d)
        s_r = step_r.clone().requires_grad_(True)
        s_q = step_q.clone().requires_grad_(True)
        with torch.enable_grad():
            rq = quant.fake_quant_lsq(w_new_r.detach(), s_r, cfg.bits, gscale)
            qq = quant.fake_quant_lsq(w_new_q.detach(), s_q, cfg.bits, gscale)
            occ = (alpt_core.take_rows(rq, inv_r) * alpt_core.take_rows(qq, inv_q)).reshape(
                *ids.shape, d)
            if spec.d != d:
                occ = occ[..., : spec.d]
            g_sr, g_sq = torch.autograd.grad(loss_from_rows(occ), [s_r, s_q])
        new_rem = self._delta_writeback(rem1, uniq_r, w_new_r, step_r, g_sr, cfg=cfg,
                                        noise=noise[0])
        new_quo = self._delta_writeback(quo1, uniq_q, w_new_q, step_q, g_sq, cfg=cfg,
                                        noise=noise[1])
        aux = {"step_grad_norm": torch.sqrt(torch.sum(torch.square(g_sr))
                                            + torch.sum(torch.square(g_sq))),
               "mean_step": 0.5 * (torch.mean(new_rem.step) + torch.mean(new_quo.step))}
        return QRLPTTable(remainder=new_rem, quotient=new_quo, r=state.r), aux

    def dense_update(self, state, opt, grads, *, spec, lr, weight_decay, noise=None,
                     delta_grad=None, batch_rows=None):
        """Segment-summed sub-table gradients, then the joint two-sub-table
        Delta sub-step (``delta_grad`` takes (remainder, quotient) pairs of
        the updated live rows and step vectors)."""
        cfg = self._acfg(spec, weight_decay)
        r, q_rows = hashing.qr_rows(spec.n, spec.hash_compression)
        g_rem, g_quo = self._dense_grads(state, grads, spec)
        upd_r = alpt_core.dense_weight_update(state.remainder, g_rem, cfg=cfg, lr=lr)
        upd_q = alpt_core.dense_weight_update(state.quotient, g_quo, cfg=cfg, lr=lr)
        gscale = alpt_core.grad_scale_factor(cfg, batch_rows=int(batch_rows), dim=spec.d)
        # Line 4 at the caller's updated params; live geometry only (pad rows
        # and columns are never looked up), gradients padded back.
        g_sr, g_sq = delta_grad((upd_r.w_new[:r, : spec.d], upd_q.w_new[:q_rows, : spec.d]),
                                (state.remainder.step[:r], state.quotient.step[:q_rows]),
                                gscale)
        g_sr = torch.nn.functional.pad(g_sr, (0, state.remainder.n_rows - g_sr.shape[0]))
        g_sq = torch.nn.functional.pad(g_sq, (0, state.quotient.n_rows - g_sq.shape[0]))
        new_rem = alpt_core.dense_finish(state.remainder, upd_r, g_sr, cfg=cfg, noise=noise[0])
        new_quo = alpt_core.dense_finish(state.quotient, upd_q, g_sq, cfg=cfg, noise=noise[1])
        aux = {"step_grad_norm": torch.sqrt(torch.sum(torch.square(g_sr))
                                            + torch.sum(torch.square(g_sq))),
               "mean_step": 0.5 * (torch.mean(new_rem.step) + torch.mean(new_quo.step))}
        return QRLPTTable(remainder=new_rem, quotient=new_quo, r=state.r), None, aux

    def dense_delta_grad(self, w_new, step_vec, loss_fn_q, *, spec, weight_decay, gscale):
        """Joint Delta gradient through the composed table: ``w_new`` and
        ``step_vec`` are (remainder, quotient) pairs; ``loss_fn_q`` scores
        the fake-quantized product table."""
        cfg = self._acfg(spec, weight_decay)
        r, _ = hashing.qr_rows(spec.n, spec.hash_compression)
        w_r, w_q = w_new
        ids = torch.arange(spec.n, device=w_r.device)
        rid, qid = ids % r, torch.div(ids, r, rounding_mode="floor")
        s_r = step_vec[0].detach().clone().requires_grad_(True)
        s_q = step_vec[1].detach().clone().requires_grad_(True)
        with torch.enable_grad():
            rq = quant.fake_quant_lsq(w_r.detach(), s_r, cfg.bits, gscale)
            qq = quant.fake_quant_lsq(w_q.detach(), s_q, cfg.bits, gscale)
            table_q = alpt_core.take_rows(rq, rid) * alpt_core.take_rows(qq, qid)
            return tuple(alpt_core.grads_or_zeros(loss_fn_q(table_q), [s_r, s_q]))
