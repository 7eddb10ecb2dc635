"""LPT: int8 codes + per-row Delta, no fp32 master copy (port of repro/methods/lpt.py).

A thin adapter over :mod:`repro_torch.core.lpt`.  ``spec.use_kernels``
routes the init quantize through ``sr_round``, lookups through
``dequant_gather``, the row step through ``sparse_row_update`` and the dense
(LM) write-back through ``lpt_fused_update``; ``serving_state`` (inherited)
hands codes + Delta to the serving Engine as they are.
"""
from __future__ import annotations

from repro_torch.core import lpt as lpt_core
from repro_torch.dist.sharding import P
from repro_torch.methods.base import IntegerTableMethod, pad_grads, register


@register("lpt")
class LPTMethod(IntegerTableMethod):
    # Vanilla LPT fixes Delta from the tuned clip value; ALPT overrides this.
    _clip_value_of = staticmethod(lambda spec: spec.clip_value)

    def table_pspec(self, row, col, *, row_optimizer="adam"):
        slot = P(row, col) if row_optimizer == "adam" else P(row)
        return lpt_core.LPTTable(codes=P(row, col), step=P(row), mu=slot, nu=slot, count=P())

    def init(self, generator, spec):
        return lpt_core.init_table(
            generator, spec.n_padded, spec.d_padded, spec.bits,
            init_scale=spec.init_scale, clip_value=self._clip_value_of(spec),
            optimizer=spec.row_optimizer, use_kernels=spec.use_kernels,
            packed=spec.packed,
        )

    def lookup(self, state, ids, spec, grad_scale=1.0):
        return lpt_core.lookup(state, ids, use_kernels=spec.use_kernels, out_dim=spec.d)

    def memory_bytes(self, state, spec, *, training=True, stored=False):
        # Container-actual code bytes (packed widths are ceil(d*bits/8) per
        # row) + the per-row fp32 Delta (+ the row-optimizer slots).
        return lpt_core.memory_bytes(state, spec.bits, count_optimizer=stored and training)

    def sparse_apply(self, state, ids, g_rows, *, spec, lr, weight_decay, noise):
        return lpt_core.sparse_apply(
            state, ids, g_rows, lr=lr, bits=spec.bits, rounding=spec.alpt.rounding,
            noise=noise, optimizer=spec.row_optimizer, weight_decay=weight_decay,
            id_space=spec.n, use_kernels=spec.use_kernels,
        )

    def dense_table(self, state, spec):
        return lpt_core.dense_table(state)[: spec.n, : spec.d]

    def dense_update(self, state, opt, grads, *, spec, lr, weight_decay, noise=None,
                     delta_grad=None, batch_rows=None):
        new_state = lpt_core.dense_apply(
            state, pad_grads(grads, state), lr=lr, bits=spec.bits,
            rounding=spec.alpt.rounding, noise=noise, optimizer=spec.row_optimizer,
            weight_decay=weight_decay, use_kernels=spec.use_kernels,
        )
        return new_state, None, {}
