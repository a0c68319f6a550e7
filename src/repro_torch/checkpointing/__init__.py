"""Checkpointing: flattened-tree .npz files shared with the JAX package."""
from repro_torch.checkpointing.npz import (flatten, latest_step, load_tree, restore_checkpoint,
                                           save_checkpoint, save_tree)

__all__ = ["flatten", "latest_step", "load_tree", "restore_checkpoint", "save_checkpoint",
           "save_tree"]
