"""Checkpointing with atomic commit and per-leaf checksums."""
from repro_torch.checkpoint.manager import CheckpointCorruptionError, CheckpointManager

__all__ = ["CheckpointCorruptionError", "CheckpointManager"]
