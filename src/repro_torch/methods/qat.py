"""QAT baselines LSQ / PACT (paper §2.2, §4.1), port of repro/methods/qat.py:
an fp32 master copy and a fake-quantized forward.  They compress inference
(the int8 export) but not training memory.  Serving holds the export's codes
+ per-row step as a ``QuantTable``, so rows come through ``dequant_gather``.
"""
from __future__ import annotations

from repro_torch.core import qat as qat_core
from repro_torch.core.codestore import CodeStore
from repro_torch.dist.sharding import P
from repro_torch.methods.base import EmbeddingMethod, register
from repro_torch.serving import table as serving_tbl


class _QATMethod(EmbeddingMethod):
    variant: str  # 'lsq' | 'pact'

    def init(self, generator, spec):
        return qat_core.init_qat(generator, spec.n, spec.d, spec.bits, method=self.variant,
                                 init_scale=spec.init_scale)

    def lookup(self, state, ids, spec, grad_scale=1.0):
        return qat_core.qat_lookup(state, ids, spec.bits, method=self.variant,
                                   grad_scale=grad_scale)

    def trainable_params(self, state, spec):
        return {"weights": state.weights, "scale": state.scale}

    def table_pspec(self, row, col, *, row_optimizer="adam"):
        return qat_core.QATTable(weights=P(row, col), scale=P(row))

    def param_pspec(self, row, col):
        return {"weights": P(row, col), "scale": P(row)}

    def with_params(self, state, params, spec):
        return qat_core.QATTable(weights=params["weights"], scale=params["scale"])

    def checkpoint_schema(self, spec):
        return {".weights": {"shape": [spec.n, spec.d], "dtype": "float32"},
                ".scale": {"shape": [spec.n], "dtype": "float32"}}

    def memory_bytes(self, state, spec, *, training=True, stored=False):
        # Training keeps the fp master copy; inference ships codes + step.
        fp = spec.n * spec.d * 4
        if training:
            return fp + spec.n * 4
        return int(spec.n * spec.d * spec.bits / 8) + spec.n * 4

    def serving_state(self, state, spec):
        """QAT's deployment story is the int8 export: serve it integer-resident
        (codes + step; sub-byte widths packed), not re-inflated to fp32."""
        codes, step = qat_core.export_int8(state, spec.bits, method=self.variant)
        return serving_tbl.QuantTable(codes=CodeStore.from_codes(codes, spec.bits,
                                                                 packed=spec.packed),
                                      step=step, n=spec.n, d=spec.d,
                                      use_kernels=spec.use_kernels)


@register("lsq")
class LSQMethod(_QATMethod):
    variant = "lsq"


@register("pact")
class PACTMethod(_QATMethod):
    variant = "pact"
