"""Checkpoints in the reference's on-disk format (``repro/ckpt``)."""

from .checkpoint import CheckpointManager, load, save, state_leaves

__all__ = ["CheckpointManager", "load", "save", "state_leaves"]
