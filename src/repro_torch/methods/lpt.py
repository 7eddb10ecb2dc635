"""LPT: int8 codes + per-row Delta, no fp32 master copy (port of repro/methods/lpt.py).

A thin adapter over :mod:`repro_torch.core.lpt`.  ``spec.use_kernels``
routes the init quantize through ``sr_round``, lookups through
``dequant_gather`` and the row step through ``sparse_row_update``; ``serving_state``
(inherited) hands codes + Delta to the serving Engine as they are.
"""
from __future__ import annotations

from repro_torch.core import lpt as lpt_core
from repro_torch.methods.base import IntegerTableMethod, register


@register("lpt")
class LPTMethod(IntegerTableMethod):
    # Vanilla LPT fixes Delta from the tuned clip value; ALPT overrides this.
    _clip_value_of = staticmethod(lambda spec: spec.clip_value)

    def init(self, generator, spec):
        return lpt_core.init_table(
            generator, spec.n_padded, spec.d_padded, spec.bits,
            init_scale=spec.init_scale, clip_value=self._clip_value_of(spec),
            optimizer=spec.row_optimizer, use_kernels=spec.use_kernels,
            packed=spec.packed,
        )

    def lookup(self, state, ids, spec):
        return lpt_core.lookup(state, ids, use_kernels=spec.use_kernels, out_dim=spec.d)

    def memory_bytes(self, state, spec):
        # Container-actual code bytes (packed widths are ceil(d*bits/8) per
        # row) + the per-row fp32 Delta.
        return state.codes.resident_bytes + spec.n_padded * 4

    def sparse_apply(self, state, ids, g_rows, *, spec, lr, weight_decay, noise):
        return lpt_core.sparse_apply(
            state, ids, g_rows, lr=lr, bits=spec.bits, rounding=spec.alpt.rounding,
            noise=noise, optimizer=spec.row_optimizer, weight_decay=weight_decay,
            id_space=spec.n, use_kernels=spec.use_kernels,
        )
