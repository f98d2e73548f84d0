"""Checkpoints of the port (`repro.checkpoint` counterpart), in the
reference's on-disk format: either package restores the other's."""
from .manager import CheckpointManager, restore_tree, save_tree
