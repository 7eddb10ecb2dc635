"""Optimizers and learning-rate schedules (port of repro/optim)."""
from repro_torch.optim.adam import (  # noqa: F401
    OptState,
    adam_init,
    adam_update,
    clip_by_global_norm,
    make_optimizer,
    sgd_init,
    sgd_update,
    tree_leaves,
    tree_like,
)
from repro_torch.optim.schedule import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
    inv_sqrt_schedule,
    step_decay_schedule,
    warmup_cosine_schedule,
)
