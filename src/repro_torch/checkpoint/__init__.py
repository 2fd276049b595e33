"""repro_torch.checkpoint — save, commit and restore a fit's state (port of
``repro/checkpoint``)."""

from .manager import CheckpointConfig, CheckpointManager

__all__ = ["CheckpointManager", "CheckpointConfig"]
