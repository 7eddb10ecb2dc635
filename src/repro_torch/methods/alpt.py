"""ALPT: LPT + a learned per-row Delta (port of repro/methods/alpt.py).

Inherits the LPT table handling and overrides the train step with
Algorithm 1's two sub-steps: the weight update, then Delta learned through a
second fake-quant forward at the *updated* dense params.  ``spec.use_kernels``
flows into :class:`~repro_torch.core.alpt.ALPTConfig`, so the weight step
runs through ``sparse_row_update`` and the line-5 re-quantize through
``sr_round``.  Serving ships the codes and the learned Delta as they are
(inherited ``serving_state``).
"""
from __future__ import annotations

from repro_torch.core import alpt as alpt_core
from repro_torch.methods.base import register
from repro_torch.methods.lpt import LPTMethod


@register("alpt")
class ALPTMethod(LPTMethod):
    # ALPT learns Delta from the LSQ-style init; the clip knob is LPT-only.
    _clip_value_of = staticmethod(lambda spec: None)
    noise_draws = 2  # step 1's write-back and line 5's re-quantize

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
