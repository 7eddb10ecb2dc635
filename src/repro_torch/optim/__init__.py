"""Optimizers and learning-rate schedules (port of repro/optim)."""
from repro_torch.optim.adam import OptState, adam_init, adam_update  # noqa: F401
