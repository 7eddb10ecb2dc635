"""DeepLight-style magnitude pruning baseline (Deng et al. 2021; §4.1/B.2),
port of repro/methods/prune.py: dense fp32 weights and a magnitude mask the
trainer recomputes every ``spec.prune.update_every`` steps."""
from __future__ import annotations

from repro_torch.core import pruning
from repro_torch.dist.sharding import P
from repro_torch.methods.base import EmbeddingMethod, register


@register("prune")
class PruneMethod(EmbeddingMethod):
    has_host_refresh = True

    def init(self, generator, spec):
        return pruning.init_prune(generator, spec.n, spec.d, init_scale=spec.init_scale)

    def lookup(self, state, ids, spec, grad_scale=1.0):
        return pruning.prune_lookup(state, ids)

    def trainable_params(self, state, spec):
        return {"weights": state.weights}

    def table_pspec(self, row, col, *, row_optimizer="adam"):
        return pruning.PruneState(weights=P(row, col), mask=P(row, col), step=P())

    def param_pspec(self, row, col):
        return {"weights": P(row, col)}

    def with_params(self, state, params, spec):
        return state._replace(weights=params["weights"])

    def checkpoint_schema(self, spec):
        return {".weights": {"shape": [spec.n, spec.d], "dtype": "float32"},
                ".mask": {"shape": [spec.n, spec.d], "dtype": "bool"},
                ".step": {"shape": [], "dtype": "int32"}}

    def memory_bytes(self, state, spec, *, training=True, stored=False):
        fp = spec.n * spec.d * 4
        if training:
            # Unstructured sparsity: dense weights + a 1-bit mask (a bool,
            # one byte per weight, as stored).
            return fp + (spec.n * spec.d if stored else spec.n * spec.d // 8)
        # The kept weights: fp * mean(mask), counted exactly.
        return 4 * int(state.mask.sum())

    def host_sync(self, state, step, spec):
        # The pruning-ratio schedule reads a host-driven step clock.
        return state._replace(step=int(step))

    def host_refresh(self, state, spec):
        return pruning.update_mask(state, spec.prune)

    def refresh_every(self, spec):
        return spec.prune.update_every
