"""ALPT: LPT + a learned per-row Delta (port of repro/methods/alpt.py).

Inherits the LPT table handling and overrides the train step with
Algorithm 1's two sub-steps: the weight update, then Delta learned through a
second fake-quant forward at the *updated* dense params.  ``spec.use_kernels``
flows into :class:`~repro_torch.core.alpt.ALPTConfig`, so the weight step
runs through ``sparse_row_update`` (CTR) or the dense float update (LM), and
the line-5 re-quantize through ``sr_round``.  Serving ships the codes and the
learned Delta as they are (inherited ``serving_state``).
"""
from __future__ import annotations

import torch

from repro_torch.core import alpt as alpt_core
from repro_torch.methods.base import pad_grads, register
from repro_torch.methods.lpt import LPTMethod


@register("alpt")
class ALPTMethod(LPTMethod):
    # ALPT learns Delta from the LSQ-style init; the clip knob is LPT-only.
    _clip_value_of = staticmethod(lambda spec: None)
    has_learned_step = True

    def noise_draws(self, spec):
        return 2  # step 1's write-back and line 5's re-quantize

    @staticmethod
    def _acfg(spec, weight_decay) -> alpt_core.ALPTConfig:
        # spec.bits is the table's storage width (it sized the code
        # container); a stale ALPTConfig.bits must not write wider codes.
        return spec.alpt._replace(
            bits=spec.bits, weight_decay=weight_decay,
            optimizer=spec.row_optimizer, use_kernels=spec.use_kernels,
        )

    def fused_row_step(self, state, ids, *, spec, loss_from_rows, dense_params,
                       update_dense, lr, weight_decay, noise):
        # One backward gives df/drows and df/ddense at the current params
        # (the reference runs the same function twice); the dense update
        # (Algorithm 1 line 3) then moves the params that line 4 reads.
        loss, g_rows, g_dense = self.row_grads(state, ids, spec=spec,
                                               loss_from_rows=loss_from_rows,
                                               dense_params=dense_params)
        update_dense(g_dense)
        new_state, aux = alpt_core.alpt_step(
            state, ids, g_rows, loss_from_rows, cfg=self._acfg(spec, weight_decay), lr=lr,
            noise=noise, id_space=spec.n, out_dim=spec.d,
        )
        return new_state, {"loss": loss, **aux}

    def dense_update(self, state, opt, grads, *, spec, lr, weight_decay, noise=None,
                     delta_grad=None, batch_rows=None):
        acfg = self._acfg(spec, weight_decay)
        upd = alpt_core.dense_weight_update(state, pad_grads(grads, state), cfg=acfg, lr=lr)
        gscale = alpt_core.grad_scale_factor(acfg, batch_rows=int(batch_rows), dim=spec.d)
        # Algorithm 1 line 4 at the caller's UPDATED dense params, on the
        # live (n, d) table; a padded table's Delta gradient is zero-padded
        # back (its scratch rows are untouched).
        g_step = delta_grad(upd.w_new[: spec.n, : spec.d], state.step[: spec.n], gscale)
        if g_step.shape != state.step.shape:
            g_step = torch.nn.functional.pad(g_step, (0, state.step.shape[0] - g_step.shape[0]))
        new_state = alpt_core.dense_finish(state, upd, g_step, cfg=acfg, noise=noise)
        aux = {"step_grad_norm": torch.linalg.vector_norm(g_step),
               "mean_step": torch.mean(new_state.step)}
        return new_state, None, aux

    def dense_delta_grad(self, w_new, step_vec, loss_fn_q, *, spec, weight_decay, gscale):
        return alpt_core.dense_delta_grad(w_new, step_vec, loss_fn_q,
                                          cfg=self._acfg(spec, weight_decay), gscale=gscale)
