"""Checkpoints of the port (see :mod:`repro_torch.checkpoint.manager`)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    CorruptCheckpointError,
    check_embedding_manifest,
    config_hash,
    embedding_manifest,
    load_pytree,
    restore_serving_checkpoint,
    save_pytree,
    save_serving_checkpoint,
    serving_template,
)

__all__ = [
    "CheckpointManager",
    "CorruptCheckpointError",
    "check_embedding_manifest",
    "config_hash",
    "embedding_manifest",
    "load_pytree",
    "restore_serving_checkpoint",
    "save_pytree",
    "save_serving_checkpoint",
    "serving_template",
]
