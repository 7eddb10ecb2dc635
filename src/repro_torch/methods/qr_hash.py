"""QR compositional-embedding baseline (Shi et al. 2020; paper §4.1), port of
repro/methods/qr_hash.py: remainder and quotient fp32 tables composed by an
element-wise product."""
from __future__ import annotations

from repro_torch.core import hashing
from repro_torch.dist.sharding import P
from repro_torch.methods.base import EmbeddingMethod, register


@register("hash")
class QRHashMethod(EmbeddingMethod):
    def init(self, generator, spec):
        return hashing.init_qr(generator, spec.n, spec.d, compression=spec.hash_compression,
                               init_scale=spec.init_scale)

    def lookup(self, state, ids, spec, grad_scale=1.0):
        return hashing.qr_lookup(state, ids)

    def trainable_params(self, state, spec):
        return hashing.qr_params(state)

    def table_pspec(self, row, col, *, row_optimizer="adam"):
        # Sub-table row counts rarely divide the mesh axes; stay replicated.
        return hashing.QRTable(remainder=P(), quotient=P(), r=P())

    def param_pspec(self, row, col):
        return {"remainder": P(), "quotient": P()}

    def with_params(self, state, params, spec):
        return hashing.QRTable(remainder=params["remainder"], quotient=params["quotient"],
                               r=state.r)

    def checkpoint_schema(self, spec):
        r, q_rows = hashing.qr_rows(spec.n, spec.hash_compression)
        return {".remainder": {"shape": [r, spec.d], "dtype": "float32"},
                ".quotient": {"shape": [q_rows, spec.d], "dtype": "float32"},
                ".r": {"shape": [], "dtype": "int32"}}

    def memory_bytes(self, state, spec, *, training=True, stored=False):
        return hashing.qr_memory_bytes(state)
