"""Full-precision fp32 table — the paper's accuracy reference (port of repro/methods/fp.py)."""
from __future__ import annotations

import torch

from repro_torch.methods.base import EmbeddingMethod, register


@register("fp")
class FPMethod(EmbeddingMethod):
    def init(self, generator, spec):
        return torch.randn((spec.n, spec.d), generator=generator, dtype=torch.float32,
                           device=generator.device) * spec.init_scale

    def lookup(self, state, ids, spec):
        return state[ids]

    def memory_bytes(self, state, spec):
        return spec.n * spec.d * 4

    def trainable_params(self, state, spec):
        return state

    def with_params(self, state, params, spec):
        return params
