"""Optimizers and learning-rate schedules (port of repro/optim)."""
from repro_torch.optim.adam import (  # noqa: F401
    OptState,
    adam_init,
    adam_update,
    clip_by_global_norm,
    tree_leaves,
    tree_like,
)
