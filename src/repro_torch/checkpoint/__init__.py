"""Log-structured checkpoints of the training state (ckpt.py)."""

from .ckpt import CheckpointStore
