from .checkpointer import CheckpointManager

__all__ = ["CheckpointManager"]
